"""BERT-family bidirectional text encoder: the embeddings of the pooling
routes (/v1/embeddings, rerank, score) when ``--embedding-model`` is set
(``production_stack_tpu/models/encoder.py``).

A sentence-transformers-style encoder: BERT post-LN layers,
bidirectional attention, mean pooling over the valid tokens. The weights
keep the JAX layout, every layer's tensors stacked on a leading layer
axis and the matrices stored ``[L, in, out]`` (``x @ w[l]``), in an
``nn.Module``; ``encode_hidden`` loops over the layers in Python where
JAX scans. The JAX package computes the encoder with plain XLA ops and no
Pallas kernel, so plain torch ops are the port, with the JAX arithmetic:
f32 LayerNorm (eps 1e-12 for BERT), the token-type embedding's row 0,
scores in f32 times ``head_dim**-0.5`` with a -1e30 bias on padding
keys, the softmax cast to the value dtype, and exact-erf GELU. The
default dtype is float32, as in JAX.

``params_from_state_dict`` maps an HF ``BertModel`` state dict (names
with an optional ``bert.`` or ``model.`` prefix, torch ``[out, in]``
weights transposed) and ``load_checkpoint`` reads a checkpoint directory
through the port's own reader (models/hf_loader.py: ``*.safetensors``
without the ``safetensors`` package, else ``*.bin``).

Random weights (``init_params``) come from a ``torch.Generator``: other
values than the JAX package's threefry draw from the same seed. Parity
with JAX carries its weights across (weights.encoder_params_from_jax) or
loads one checkpoint directory in both.
"""

import dataclasses
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models.hf_loader import read_state_dict
from production_stack_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class EncoderConfig:
    name: str = "debug-encoder"
    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


ENCODER_PRESETS: Dict[str, EncoderConfig] = {
    # debug geometry (tests, --embedding-model debug-encoder)
    "debug-encoder": EncoderConfig(
        name="debug-encoder", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4,
        max_position_embeddings=128),
    # sentence-transformers/all-MiniLM-L6-v2
    "minilm-l6": EncoderConfig(
        name="minilm-l6", vocab_size=30522, hidden_size=384,
        intermediate_size=1536, num_layers=6, num_heads=12),
    # bert-base (BAAI/bge-base-en-v1.5's geometry)
    "bert-base": EncoderConfig(
        name="bert-base", vocab_size=30522, hidden_size=768,
        intermediate_size=3072, num_layers=12, num_heads=12),
}

# the embedding tensors; the others are per layer, stacked on axis 0
EMBED_KEYS = ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b")
# the matrices, drawn N(0, 0.02) by init_params
_MATRICES = ("word_emb", "pos_emb", "type_emb", "q", "k", "v", "o", "up",
             "down")


def get_encoder_config(name: str) -> EncoderConfig:
    if name not in ENCODER_PRESETS:
        raise ValueError(
            f"unknown encoder preset {name!r}; known: "
            f"{sorted(ENCODER_PRESETS)} (or pass a HF checkpoint dir)")
    return ENCODER_PRESETS[name]


class Encoder(nn.Module):
    """An encoder's parameters, JAX layout, no gradients: word_emb
    [V, H], pos_emb [P, H], type_emb [TV, H], emb_ln_w/b [H]; per layer
    q/k/v/o [L, H, H] with biases [L, H], attn_ln_w/b [L, H], up
    [L, H, I] + up_b [L, I], down [L, I, H] + down_b [L, H], out_ln_w/b
    [L, H]. ``encode_hidden`` and ``encode`` run them."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        shapes = {
            "word_emb": (cfg.vocab_size, h),
            "pos_emb": (cfg.max_position_embeddings, h),
            "type_emb": (cfg.type_vocab_size, h),
            "emb_ln_w": (h,), "emb_ln_b": (h,),
            "q": (L, h, h), "q_b": (L, h), "k": (L, h, h), "k_b": (L, h),
            "v": (L, h, h), "v_b": (L, h), "o": (L, h, h), "o_b": (L, h),
            "attn_ln_w": (L, h), "attn_ln_b": (L, h),
            "up": (L, h, i), "up_b": (L, i),
            "down": (L, i, h), "down_b": (L, h),
            "out_ln_w": (L, h), "out_ln_b": (L, h),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device),
                requires_grad=False))


@torch.no_grad()
def init_params(cfg: EncoderConfig, generator: torch.Generator,
                device="cuda") -> Encoder:
    """Random init as the JAX init shapes it: matrices N(0, 0.02) in
    cfg.dtype, drawn in f32 from `generator` (which must live on
    `device`), biases zeros, LayerNorm gains ones."""
    model = Encoder(cfg, device=device)
    for name, p in model.named_parameters():
        if name in _MATRICES:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    * 0.02)
        elif name.endswith("_ln_w"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


@torch.no_grad()
def encode_hidden(params: Encoder, cfg: EncoderConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """tokens [N, T] int (right-padded, every id < vocab_size), lengths
    [N] -> final-layer hidden states [N, T, H] in cfg.dtype (padding
    rows are garbage the caller masks)."""
    N, T = tokens.shape
    mask = (torch.arange(T, device=tokens.device)[None, :]
            < lengths[:, None])                                # [N, T]
    x = (params.word_emb[tokens] + params.pos_emb[None, :T]
         + params.type_emb[0][None, None])
    x = _layer_norm(x, params.emb_ln_w, params.emb_ln_b, cfg.layer_norm_eps)
    nh, hd = cfg.num_heads, cfg.head_dim
    # padding keys are masked out of every softmax; padding queries give
    # garbage rows the pooling mask drops
    bias = torch.where(mask, 0.0, -1e30).to(torch.float32)[:, None, None, :]
    for l in range(cfg.num_layers):
        def lin(h, name):
            return h @ getattr(params, name)[l] \
                + getattr(params, name + "_b")[l]

        q = lin(x, "q").reshape(N, T, nh, hd)
        k = lin(x, "k").reshape(N, T, nh, hd)
        v = lin(x, "v").reshape(N, T, nh, hd)
        # f32 scores, as JAX's preferred_element_type=float32
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        s = s * (hd ** -0.5) + bias
        p = torch.softmax(s, dim=-1).to(v.dtype)
        attn = torch.einsum("bhts,bshd->bthd", p, v).reshape(N, T, -1)
        x = _layer_norm(x + lin(attn, "o"), params.attn_ln_w[l],
                        params.attn_ln_b[l], cfg.layer_norm_eps)
        ff = lin(F.gelu(lin(x, "up"), approximate="none"), "down")
        x = _layer_norm(x + ff, params.out_ln_w[l], params.out_ln_b[l],
                        cfg.layer_norm_eps)
    return x


@torch.no_grad()
def encode(params: Encoder, cfg: EncoderConfig, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """tokens [N, T] int (right-padded), lengths [N] -> mean-pooled
    embeddings f32 [N, H]: the sum of the valid hidden states over
    max(length, 1)."""
    T = tokens.shape[1]
    mask = (torch.arange(T, device=tokens.device)[None, :]
            < lengths[:, None])
    x = encode_hidden(params, cfg, tokens, lengths)
    pooled = (x.float() * mask[:, :, None]).sum(dim=1)
    return pooled / lengths.clamp(min=1)[:, None]


@torch.no_grad()
def params_from_state_dict(cfg: EncoderConfig, sd: Mapping[str, Any],
                           device="cuda") -> Encoder:
    """An HF BertModel state dict (name -> tensor or array; names may
    carry a ``bert.`` or ``model.`` prefix) as the stacked layout in
    cfg.dtype on `device`; Linear weights [out, in] are transposed."""
    model = Encoder(cfg, device=device)

    def get(name):
        for pfx in ("", "bert.", "model."):
            if pfx + name in sd:
                return torch.as_tensor(sd[pfx + name])
        raise KeyError(name)

    e, lay = "embeddings.", "encoder.layer.{}."
    hf = {
        "word_emb": e + "word_embeddings.weight",
        "pos_emb": e + "position_embeddings.weight",
        "type_emb": e + "token_type_embeddings.weight",
        "emb_ln_w": e + "LayerNorm.weight", "emb_ln_b": e + "LayerNorm.bias",
    }
    per_layer = {
        "q": ("attention.self.query.weight", True),
        "q_b": ("attention.self.query.bias", False),
        "k": ("attention.self.key.weight", True),
        "k_b": ("attention.self.key.bias", False),
        "v": ("attention.self.value.weight", True),
        "v_b": ("attention.self.value.bias", False),
        "o": ("attention.output.dense.weight", True),
        "o_b": ("attention.output.dense.bias", False),
        "attn_ln_w": ("attention.output.LayerNorm.weight", False),
        "attn_ln_b": ("attention.output.LayerNorm.bias", False),
        "up": ("intermediate.dense.weight", True),
        "up_b": ("intermediate.dense.bias", False),
        "down": ("output.dense.weight", True),
        "down_b": ("output.dense.bias", False),
        "out_ln_w": ("output.LayerNorm.weight", False),
        "out_ln_b": ("output.LayerNorm.bias", False),
    }
    for name, p in model.named_parameters():
        if name in hf:
            p.copy_(_checked(get(hf[name]), p, name))
            continue
        suffix, transpose = per_layer[name]
        for l in range(cfg.num_layers):
            t = get(lay.format(l) + suffix)
            p[l].copy_(_checked(t.T if transpose else t, p[l], name))
    return model


def _checked(t: torch.Tensor, p: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(p.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                         f"encoder shape {tuple(p.shape)}")
    return t


def load_checkpoint(cfg: EncoderConfig, path: str, device="cuda") -> Encoder:
    """The encoder of an HF BertModel checkpoint directory."""
    return params_from_state_dict(cfg, read_state_dict(path), device=device)


def config_from_hf_json(d: Mapping[str, Any],
                        name: str = "") -> EncoderConfig:
    """EncoderConfig from a HF BERT config.json dict."""
    return EncoderConfig(
        name=name or d.get("_name_or_path", "hf-encoder"),
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        max_position_embeddings=d.get("max_position_embeddings", 512),
        type_vocab_size=d.get("type_vocab_size", 2),
        layer_norm_eps=d.get("layer_norm_eps", 1e-12),
    )
