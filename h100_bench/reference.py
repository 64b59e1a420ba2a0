"""The plain reference: the Mistral decoder written from the published
description (Hugging Face ``MistralForCausalLM``) in plain PyTorch,
with no kernel, cache or batching of the program. It imports nothing of
the program.

It runs a layer at a time: the layer's weights are drawn again from the
seed (weights.py), every sampled sequence goes through the layer, and
the weights are dropped before the next layer, so its float32 weights
never sit on the card whole.

Precisions (``PRECISIONS``):
- ``f32``, the reference: float32 activations and weights, TF32 off, so
  a float32 product is a float32 product.
- ``w8a16``, the control: the reference put in the program's place one
  precision below the bfloat16 the configuration states, activations in
  bfloat16 and the weights quantized to int8 per output channel (the
  embedding per row), the leaves the port's int8 recipe quantizes.

Layer equations (pre-norm, as published): x += Wo attn(rope(Wq n(x)),
rope(Wk n(x)), Wv n(x)); x += down(silu(gate n(x)) * up n(x)), with n
the RMSNorm (f32, eps from the config) times its gain, rope the
non-interleaved rotary embedding at theta (angles in float32 as the
published code computes them), attn causal GQA softmax((q k^T) /
sqrt(D)) v over the keys j with i - W < j <= i where the config has a
sliding window W.
"""

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from h100_bench import weights as W

PRECISIONS = ("f32", "w8a16")
# query rows per attention block: bounds the f32 score tile
_Q_BLOCK = 512


def _int8(name: str, w: torch.Tensor) -> torch.Tensor:
    """The control's weight transform: int8 per output channel (the
    last axis; the embedding per row), symmetric, round half to even,
    back to float32."""
    axis = -1 if name == "embed" else -2
    s = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / 127
    return torch.round(w / s).clamp(-127, 127) * s


class Reference:
    """The reference model of one configuration file at one seed."""

    def __init__(self, cfg: dict, seed: int, device,
                 precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.m = W.dims(cfg)
        self.precision = precision
        self.act = torch.float32 if precision == "f32" else torch.bfloat16
        self._quant = _int8 if precision == "w8a16" else None

    def _weight(self, name: str, layer: Optional[int]) -> torch.Tensor:
        w = W.draw(self.cfg, self.seed, name, layer, self.device).float()
        if self._quant is not None and name in W.INT8_LEAVES:
            w = self._quant(name, w)
        return w if name in W.NORMS else w.to(self.act)

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True)
                             + self.m["eps"])
        return (y * g.float()).to(self.act)

    def _rope(self, T: int):
        D = self.m["D"]
        inv = 1.0 / (self.m["theta"] ** (torch.arange(
            0, D, 2, dtype=torch.int64, device=self.device).float() / D))
        ang = torch.arange(T, device=self.device).float()[:, None] * inv
        ang = torch.cat([ang, ang], dim=-1)
        return ang.cos()[:, None, :], ang.sin()[:, None, :]

    @staticmethod
    def _rotate(x, cos, sin):
        xf = x.float()
        x1, x2 = xf.chunk(2, dim=-1)
        return xf * cos + torch.cat([-x2, x1], dim=-1) * sin

    def _attention(self, q, k, v):
        """q [T, NH, D], k/v [T, NKV, D] -> [T, NH*D]."""
        T, NH, D = q.shape
        NKV = k.shape[1]
        G = NH // NKV
        win = self.m["window"]
        out = torch.empty((T, NH, D), dtype=self.act, device=self.device)
        qg = q.reshape(T, NKV, G, D)
        for q0 in range(0, T, _Q_BLOCK):
            q1 = min(q0 + _Q_BLOCK, T)
            lo = max(0, q0 - win + 1) if win else 0
            s = torch.einsum("qhgd,khd->hgqk", qg[q0:q1].float(),
                             k[lo:q1].float()) * D ** -0.5
            i = torch.arange(q0, q1, device=self.device)[:, None]
            j = torch.arange(lo, q1, device=self.device)[None, :]
            keep = j <= i
            if win:
                keep = keep & (j > i - win)
            s = s.masked_fill(~keep, float("-inf"))
            p = torch.softmax(s, dim=-1).to(self.act)
            o = torch.einsum("hgqk,khd->qhgd", p, v[lo:q1].to(self.act))
            out[q0:q1] = o.reshape(q1 - q0, NH, D)
        return out.reshape(T, NH * D)

    def _mlp(self, h, lw):
        return (F.silu(h @ lw["gate"]) * (h @ lw["up"])) @ lw["down"]

    def _layer(self, x, lw, rope):
        T = x.shape[0]
        NH, NKV, D = self.m["NH"], self.m["NKV"], self.m["D"]
        h = self._norm(x, lw["attn_norm"])
        q = self._rotate((h @ lw["q"]).reshape(T, NH, D), *rope)
        k = self._rotate((h @ lw["k"]).reshape(T, NKV, D), *rope)
        v = (h @ lw["v"]).reshape(T, NKV, D)
        x = x + self._attention(q.to(self.act), k.to(self.act), v) @ lw["o"]
        return x + self._mlp(self._norm(x, lw["mlp_norm"]), lw)

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               firsts: Sequence[int]) -> List[torch.Tensor]:
        """f32 logits [T_i - first_i, V] of each token sequence at its
        positions first_i .. T_i - 1 (the whole causal forward runs; the
        head only at those positions)."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            emb = self._weight("embed", None)
            xs = [emb[s.to(self.device).long()].to(self.act) for s in seqs]
            del emb
            ropes: Dict[int, tuple] = {}
            for layer in range(self.m["L"]):
                lw = {n: self._weight(n, layer)
                      for n in W.layer_shapes(self.cfg)}
                for i, x in enumerate(xs):
                    T = x.shape[0]
                    if T not in ropes:
                        ropes[T] = self._rope(T)
                    xs[i] = self._layer(x, lw, ropes[T])
                del lw
            g = self._weight("final_norm", None)
            head = self._weight("lm_head", None)
            return [(self._norm(x[f:], g) @ head).float()
                    for x, f in zip(xs, firsts)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's logit lies below the row's best [n]."""
    tokens = tokens.to(logits.device).long()
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]
