"""Paged KV cache: a global block pool + per-slot block tables
(``production_stack_tpu/models/kv.py``).

Layout ``k, v [L, N, Hkv, Bs, D]``, head-major: a (block, kv-head) panel
is a contiguous [Bs, D] tile, which the CUDA kernels stream panel by
panel (ops/paged_attention.py). Block 0 is the trash block: never
allocated, it takes the writes of parked rows, padding tokens and
positions past the virtual capacity.

Where the JAX module returns a new pool from ``.at[].set`` (donated, so
XLA updates in place), ``write_chunk`` here writes the pool in place
with ``index_put_`` and returns it.

The int8 pool (``make_cache(dtype=torch.int8)``, ``kv.py:45-90,158-224``)
holds int8 K/V plus one f32 scale per (token, head), ``ks``/``vs``
``[L, N, Hkv, Bs]``: value = int8 * scale (``quantize_chunk``, the
weight recipe over the head dim). ``write_chunk_q`` / ``write_at_q``
quantize and scatter payload and scales through the same addresses;
``gather_view_q`` dequantizes in f32 and casts the product, as the
kernels dequantize in f32.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from production_stack_tpu_torch.utils import resolve_device


@dataclass
class KVCache:
    k: torch.Tensor  # [L, N, Hkv, Bs, D]
    v: torch.Tensor  # [L, N, Hkv, Bs, D]
    # int8 pool only: per-(token, head) dequant scales, value = int8 *
    # scale; None = full-precision pool
    ks: Optional[torch.Tensor] = None  # [L, N, Hkv, Bs] f32
    vs: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.ks is not None


_KV_DTYPES = (torch.bfloat16, torch.float32, torch.int8)


def make_cache(num_layers: int, num_blocks: int, block_size: int,
               num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    """Block pool. num_blocks INCLUDES the reserved trash block 0.
    dtype torch.int8 allocates the quantized pool: int8 payload plus
    per-(token, head) f32 scales, zeros. Raises without CUDA unless
    device="cpu" is asked for."""
    device = resolve_device(device)
    if dtype not in _KV_DTYPES:
        raise NotImplementedError(
            f"kv dtype {dtype} is not implemented in the port "
            f"(bfloat16, float32 or int8)")
    shape = (num_layers, num_blocks, num_kv_heads, block_size, head_dim)
    cache = KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
    if dtype == torch.int8:
        cache.ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache.vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def linear_tables(num_slots: int, max_len: int, block_size: int,
                  device="cuda") -> torch.Tensor:
    """Identity tables [B, MB]: slot b owns blocks 1 + b*MB .. (block 0
    stays trash)."""
    device = resolve_device(device)
    mb = -(-max_len // block_size)
    return (1 + torch.arange(num_slots * mb, dtype=torch.int32,
                             device=device)).reshape(num_slots, mb)


def make_slot_cache(num_layers: int, num_slots: int, max_len: int,
                    num_kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16, block_size: int = 64,
                    device="cuda") -> Tuple[KVCache, torch.Tensor]:
    """(pool, tables) equivalent to a per-slot contiguous cache."""
    block_size = min(block_size, max(8, max_len))
    mb = -(-max_len // block_size)
    cache = make_cache(num_layers, num_slots * mb + 1, block_size,
                       num_kv_heads, head_dim, dtype, device)
    return cache, linear_tables(num_slots, max_len, block_size, device)


def chunk_addresses(tables: torch.Tensor, positions: torch.Tensor,
                    block_size: int, valid: Optional[torch.Tensor],
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat block ids, flat intra-block offsets) for a [B, T] chunk of
    virtual positions. Tokens that are invalid, negative, or beyond the
    virtual capacity MB*Bs go to trash block 0. The same for every
    layer, so the forward computes them once."""
    Bs = block_size
    MB = tables.shape[1]
    bi = torch.clamp(torch.div(positions, Bs, rounding_mode="floor"),
                     0, MB - 1).long()
    blk = torch.gather(tables, 1, bi)
    off = torch.remainder(positions, Bs)
    oob = (positions < 0) | (positions >= MB * Bs)
    if valid is not None:
        oob = oob | ~valid
    blk = torch.where(oob, torch.zeros_like(blk), blk)
    return blk.reshape(-1).long(), off.reshape(-1).long()


def write_at(cache_layer: torch.Tensor, new: torch.Tensor,
             blk: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Scatter new [B,T,Hkv,D] into the pool layer [N,Hkv,Bs,D] IN PLACE
    at chunk_addresses' (block, offset) pairs, and return it."""
    # advanced indices on the block and offset axes land each token's
    # [Hkv, D] slab at its (block, head-major row) home
    cache_layer[blk, :, off, :] = new.reshape(
        (blk.shape[0],) + tuple(new.shape[2:])).to(cache_layer.dtype)
    return cache_layer


def write_chunk(cache_layer: torch.Tensor, new: torch.Tensor,
                tables: torch.Tensor, positions: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter new [B,T,Hkv,D] into the pool layer [N,Hkv,Bs,D] IN PLACE
    and return it. positions [B,T] are virtual positions; tokens with
    valid == False route to the trash block."""
    blk, off = chunk_addresses(tables, positions, cache_layer.shape[2],
                               valid)
    return write_at(cache_layer, new, blk, off)


def quantize_chunk(new: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8 over the head dim: new
    [B,T,Hkv,D] -> (int8 same shape, f32 scale [B,T,Hkv]), value = int8 *
    scale (models/quant.quantize_tensor's recipe, one scale per cached
    vector)."""
    f = new.float()
    amax = torch.clamp(f.abs().amax(dim=-1), min=1e-8)
    # a true division on every device: CUDA divides by a Python scalar
    # as a multiply by its f32 reciprocal, which puts ~2 % of the scales
    # one ulp from the CPU's and from the JAX source's recipe
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def write_at_q(cache_layer: torch.Tensor, scale_layer: torch.Tensor,
               new: torch.Tensor, blk: torch.Tensor, off: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """write_at for the int8 pool: quantize new [B,T,Hkv,D] and scatter
    payload and scales ([N,Hkv,Bs,D] int8, [N,Hkv,Bs] f32) IN PLACE at
    the same (block, offset) pairs; returns both."""
    q, scale = quantize_chunk(new)
    n = blk.shape[0]
    cache_layer[blk, :, off, :] = q.reshape((n,) + tuple(q.shape[2:]))
    scale_layer[blk, :, off] = scale.reshape(n, -1)
    return cache_layer, scale_layer


def write_chunk_q(cache_layer: torch.Tensor, scale_layer: torch.Tensor,
                  new: torch.Tensor, tables: torch.Tensor,
                  positions: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """write_chunk for the int8 pool (in place; returns pool and
    scales)."""
    blk, off = chunk_addresses(tables, positions, cache_layer.shape[2],
                               valid)
    return write_at_q(cache_layer, scale_layer, new, blk, off)


def gather_view(cache_layer: torch.Tensor, tables: torch.Tensor,
                nb: int) -> torch.Tensor:
    """The first nb blocks of every slot as a contiguous
    [B, nb*Bs, Hkv, D] view; view index s is virtual position s."""
    Hkv, Bs = cache_layer.shape[1], cache_layer.shape[2]
    t = tables[:, :nb].long()
    g = cache_layer[t]                                 # [B,nb,Hkv,Bs,D]
    g = g.permute(0, 1, 3, 2, 4)                       # [B,nb,Bs,Hkv,D]
    return g.reshape(t.shape[0], nb * Bs, Hkv, cache_layer.shape[-1])


def gather_view_q(cache_layer: torch.Tensor, scale_layer: torch.Tensor,
                  tables: torch.Tensor, nb: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """gather_view for the int8 pool: dequantized [B, nb*Bs, Hkv, D] in
    `dtype`. Dequantized in f32 and the PRODUCT cast, as the JAX function
    does and as the kernels dequantize in f32."""
    Hkv, Bs = cache_layer.shape[1], cache_layer.shape[2]
    t = tables[:, :nb].long()
    g = cache_layer[t].float()                          # [B,nb,Hkv,Bs,D]
    s = scale_layer[t].float()                          # [B,nb,Hkv,Bs]
    g = (g * s[..., None]).to(dtype).permute(0, 1, 3, 2, 4)
    return g.reshape(t.shape[0], nb * Bs, Hkv, cache_layer.shape[-1])
