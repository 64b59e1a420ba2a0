"""Dense Llama decoder over stacked per-layer weights
(``production_stack_tpu/models/llama.py:38-370,419-450``).

The weights keep the JAX layout: every layer's matrices are stacked on a
leading layer axis and stored ``[L, in, out]`` (``x @ w[l]``), so
carrying weights across from the JAX package is a copy, never a
transpose (weights.py). They live in an ``nn.Module``; ``forward`` loops
over the layers in Python where JAX scans.

Per layer: RMSNorm -> QKV -> RoPE -> write the chunk's K/V into the
paged pool (models/kv.write_chunk, in place) -> paged attention ->
O-proj -> SwiGLU MLP. Attention dispatches exactly as the JAX forward
does (llama.py:188-223): ``nb = min(ceil(kv_len/Bs), MB)`` blocks, and
windows of T <= DECODE_T_MAX tokens take the decode kernel, longer
chunks the prefill kernel. On CUDA tensors both are the hand-written
kernels; on the CPU their plain versions.

The slice serves the dense Llama family only: MoE, biases, Gemma's
norm/embedding conventions, sliding windows and softcaps raise
(check_supported) instead of being ignored.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import (KVCache, chunk_addresses,
                                                  linear_tables, write_at)
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.norms import rms_norm
from production_stack_tpu_torch.ops.rope import rope_rows, rope_table, rotate
from production_stack_tpu_torch.utils import resolve_device

LAYER_KEYS = ("attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up",
              "down")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse the family variations this slice does not implement."""
    unsupported = {
        "num_experts": cfg.num_experts,
        "attention_bias": cfg.attention_bias,
        "sliding_window": cfg.sliding_window,
        "attn_logit_softcap": cfg.attn_logit_softcap,
        "final_logit_softcap": cfg.final_logit_softcap,
        "query_pre_attn_scalar": cfg.query_pre_attn_scalar,
        "sandwich_norms": cfg.sandwich_norms,
        "rms_norm_offset": cfg.rms_norm_offset,
        "embed_scale": cfg.embed_scale,
        "activation": cfg.activation != "silu",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"model {cfg.name!r} needs {', '.join(bad)}, which the port "
            f"does not implement yet (dense Llama family only)")


class Llama(nn.Module):
    """Parameters of one dense Llama model, JAX layout, no gradients;
    the module-level ``forward`` runs them.

    embed [V, H]; per layer (stacked on axis 0): attn_norm/mlp_norm
    [L, H], q [L, H, NH*D], k/v [L, H, NKV*D], o [L, NH*D, H],
    gate/up [L, H, I], down [L, I, H]; final_norm [H]; lm_head [H, V]
    unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        nh, nkv, hd, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                          cfg.num_layers)
        shapes = {
            "embed": (v, h), "attn_norm": (L, h), "q": (L, h, nh * hd),
            "k": (L, h, nkv * hd), "v": (L, h, nkv * hd),
            "o": (L, nh * hd, h), "mlp_norm": (L, h), "gate": (L, h, i),
            "up": (L, h, i), "down": (L, i, h), "final_norm": (h,),
        }
        if not cfg.tie_word_embeddings:
            shapes["lm_head"] = (h, v)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device),
                requires_grad=False))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Llama:
    """Random init (normal 0.02) in cfg.dtype, drawn from `generator`
    (which must live on `device`) one layer at a time so the f32 draw
    never holds more than one layer's matrix. Norm gains are ones."""
    model = Llama(cfg, device=device)
    for name, p in model.named_parameters():
        if name in ("attn_norm", "mlp_norm", "final_norm"):
            p.fill_(1.0)
            continue
        rows = p if name in LAYER_KEYS else p.unsqueeze(0)
        for row in rows:
            row.copy_(torch.randn(row.shape, generator=generator,
                                  device=device, dtype=torch.float32)
                      * 0.02)
    return model


def _layer(cfg: ModelConfig, model: Llama, l: int, x: torch.Tensor,
           rows: Tuple[torch.Tensor, torch.Tensor], starts,
           cache: KVCache, block_tables, nb: int,
           addresses: Tuple[torch.Tensor, torch.Tensor]):
    """One transformer block; rows = this chunk's rope rows and
    addresses = its KV write addresses, both shared by every layer."""
    B, T, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    eps = cfg.rms_norm_eps
    hidden = rms_norm(x, model.attn_norm[l], eps)
    q = rotate((hidden @ model.q[l]).reshape(B, T, nh, hd), *rows)
    k = rotate((hidden @ model.k[l]).reshape(B, T, nkv, hd), *rows)
    v = (hidden @ model.v[l]).reshape(B, T, nkv, hd)
    k_pool = write_at(cache.k[l], k, *addresses)
    v_pool = write_at(cache.v[l], v, *addresses)
    attn_fn = (pa.paged_decode_attention if T <= pa.DECODE_T_MAX
               else pa.paged_attention)
    attn = attn_fn(q, k_pool, v_pool, block_tables, starts, nb=nb,
                   scale=hd ** -0.5)
    x = x + attn.reshape(B, T, nh * hd) @ model.o[l]
    hidden = rms_norm(x, model.mlp_norm[l], eps)
    gated = F.silu(hidden @ model.gate[l]) * (hidden @ model.up[l])
    return x + gated @ model.down[l]


def forward(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            block_tables: Optional[torch.Tensor] = None,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            kv_len: Optional[int] = None,
            token_valid: Optional[torch.Tensor] = None,
            last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Incremental forward. tokens/positions [B,T] -> (logits f32
    [B,T,V], cache), the cache updated in place.

    block_tables [B, MB] int32 map each row's virtual positions to pool
    blocks (None = identity tables over a make_slot_cache pool).
    positions[b] are contiguous from the row's current length. kv_len
    bounds attention to the first ceil(kv_len/Bs) blocks; every real
    query position must be < kv_len. token_valid [B,T] marks real
    tokens: the others write to the trash block. last_index [B] (torch
    addition) computes logits only at one position per row, giving
    [B,1,V] — the serving runner needs no more than that.
    rope: (cos, sin) device tensors; None builds them from the config.
    """
    device = tokens.device
    if rope is None:
        rope = rope_tensors(cfg, cfg.max_position_embeddings, device)
    B = tokens.shape[0]
    Bs = cache.block_size
    if block_tables is None:
        n_per = (cache.num_blocks - 1) // B
        block_tables = linear_tables(B, n_per * Bs, Bs, device=device)
    MB = block_tables.shape[1]
    nb = MB if kv_len is None else min(-(-kv_len // Bs), MB)
    starts = positions[:, 0].to(torch.int32).contiguous()
    rows = rope_rows(positions, *rope)
    addresses = chunk_addresses(block_tables, positions, Bs, token_valid)
    x = _embed(model, cfg, tokens)
    for l in range(cfg.num_layers):
        x = _layer(cfg, model, l, x, rows, starts, cache, block_tables, nb,
                   addresses)
    if last_index is not None:
        x = torch.gather(x, 1, last_index.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    return _lm_head(model, cfg, x), cache


def _embed(model: Llama, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.long()].to(cfg.dtype)


def _lm_head(model: Llama, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    """f32 logits [B,T,V] from bf16 or f32 activations: the product
    accumulates in f32 and is not rounded to bf16 (the JAX einsum's
    preferred_element_type=f32)."""
    head = (model.embed.t() if cfg.tie_word_embeddings
            else model.lm_head)
    B, T, H = x.shape
    x2 = x.reshape(B * T, H)
    if x.dtype == torch.float32:
        logits = x2 @ head.float()
    elif x.is_cuda:
        logits = torch.mm(x2, head, out_dtype=torch.float32)
    else:
        # CPU has no mixed-precision mm: bf16 products are exact in f32
        logits = x2.float() @ head.float()
    return logits.reshape(B, T, -1)


def rope_tensors(cfg: ModelConfig, max_positions: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) as device tensors for a cache of max_positions."""
    cos, sin = rope_table(max_positions, cfg.head_dim_, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    return (torch.from_numpy(np.ascontiguousarray(cos)).to(device),
            torch.from_numpy(np.ascontiguousarray(sin)).to(device))
