"""Causal GQA over a contiguous KV cache: the CUDA kernel's wrapper, its
plain PyTorch version and its launch count.

Replaces ``_flash_kernel`` / ``flash_attention_with_cache``
(``production_stack_tpu/ops/pallas_attention.py:120-246``), with the
same contract: q [B, T, H, D]; k/v cache [B, S, Hkv, D]; starts [B] =
absolute position of q[:, 0]; scale D**-0.5. The kernels are in
``csrc/flash_attention.cu``, whose header says what bounds them:

- bfloat16: ``flash_kernel``, tiles of 128 flattened query rows
  (``flash_tile``) on two consumer warpgroups that take turns running
  ``wgmma``, fed K/V panels by the TMA from the cache's native layout
  (keys past S arrive as zeros) through a ring of mbarrier stages that
  one producer thread fills;
- float32: the f32 FMA tile of ``csrc/attention_tile.cuh``
  (``tile_block_q``), chosen by dtype, since wgmma has no full-f32 form.

The Pallas module's runtime gates (``flash_enabled``, ``force_jnp``,
``PSTPU_FLASH``, ``flash_viable``) choose between it and the jnp path on
a TPU and have no counterpart here.

Nothing in the JAX package serves through this kernel (its forward
dispatches to the paged kernels only), so neither does the port. A
wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises.
"""

import ctypes

import torch

from production_stack_tpu_torch import kernels
from production_stack_tpu_torch.ops.attention import attention_with_cache
from production_stack_tpu_torch.ops.paged_attention import (HEAD_DIMS,
                                                            tile_block_q)

# kernel launches, counted where the kernel is launched and nowhere else
launch_counts = {"flash_attention_with_cache": 0}


def reset_launch_counts() -> None:
    launch_counts["flash_attention_with_cache"] = 0


def launch_report() -> dict:
    """A copy of the launch counter (a parallel engine's worker ranks
    answer theirs through ParallelRunner.run_on_workers)."""
    return {"launches": dict(launch_counts)}


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = kernels.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_with_cache.argtypes = ([p] * 5 + [i] * 8
                                                   + [f, p])
        lib.flash_attention_with_cache.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def flash_tile(D: int) -> dict:
    """Geometry of the bfloat16 flash kernel's tile at head dim D (as
    csrc/flash_attention.cu FlashGeometry): two consumer warpgroups of 64
    query rows each (one wgmma M) share every K/V panel, of 128 keys (64
    at D = 256, where a thread's registers hold no larger score tile), a
    ring of 4 / 3 / 2 stages at D = 64 / 128 / 256, and the shared memory
    it takes — each warpgroup's Q ([64, D] bf16) and each stage's K and V
    panel ([keys, D] bf16), plus the ring's mbarriers (128 bytes) and 1 KB
    to align the swizzled layout."""
    consumers = 2
    keys = 64 if D == 256 else 128
    stages = {64: 4, 128: 3, 256: 2}[D]
    return {"rows": 64 * consumers, "keys": keys, "stages": stages,
            "consumers": consumers,
            "smem_bytes": (128 + 1024 + consumers * 64 * D * 2
                           + 2 * stages * keys * D * 2)}


def flash_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          starts: torch.Tensor) -> torch.Tensor:
    """Plain version: attention_with_cache at positions starts + t.
    Returns [B, T, H, D] in q's dtype."""
    T = q.shape[1]
    positions = starts.long()[:, None] + torch.arange(T, device=q.device)
    return attention_with_cache(q, k_cache, v_cache,
                                positions).to(q.dtype)


def _check_cuda_args(q, k_cache, v_cache, starts):
    B, T, H, D = q.shape
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device and starts.device == q.device):
        raise ValueError("flash attention: every tensor must be on the "
                         "same CUDA device")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q and "
                        f"caches of the same dtype (got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype})")
    if starts.dtype != torch.int32:
        raise TypeError("starts must be int32")
    if (k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D
            or v_cache.shape != k_cache.shape or D not in HEAD_DIMS
            or H % k_cache.shape[2] or starts.shape != (B,)):
        raise ValueError(f"shape mismatch or unsupported head dim: q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"starts {tuple(starts.shape)} (D must be 64, 128 "
                         f"or 256)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("starts", starts)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")


def flash_attention_with_cache(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               starts: torch.Tensor) -> torch.Tensor:
    """Causal GQA of q [B,T,H,D] over a contiguous cache k/v [B,S,Hkv,D]
    that already holds the chunk's own K/V; starts [B] int32. Query t of
    row b attends slots s <= starts[b] + t."""
    if not q.is_cuda:
        return flash_attention_plain(q, k_cache, v_cache, starts)
    _check_cuda_args(q, k_cache, v_cache, starts)
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    block_q = (flash_tile(D)["rows"] if q.dtype == torch.bfloat16
               else tile_block_q(T, H // Hkv, D))
    rc = _lib().flash_attention_with_cache(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        starts.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, T, H,
        Hkv, D, S, block_q, float(D ** -0.5), stream)
    if rc != 0:
        msg = _lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_with_cache kernel launch "
                           f"failed ({rc}): {msg}")
    launch_counts["flash_attention_with_cache"] += 1
    return out
