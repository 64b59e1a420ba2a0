"""Paged causal GQA attention: the CUDA kernels' wrappers, their plain
PyTorch versions and their launch counts.

Replaces ``production_stack_tpu/ops/pallas_paged.py``:

- ``paged_decode_attention`` <- ``_paged_decode_kernel`` /
  ``paged_decode_attention`` (pallas_paged.py:325-510), T <= 8;
- ``paged_attention`` <- ``_paged_kernel`` / ``paged_attention``
  (pallas_paged.py:75-272), prefill chunks of any T.

Both kernels live in ``csrc/paged_attention.cu``, whose header says what
bounds them on an H100 (decode: device-memory bytes; prefill:
arithmetic) and what their designs do about it: decode splits the KV
axis over thread blocks (``decode_split_plan``) and merges the splits'
partials in a second launch, so one wrapper call is two launches;
bfloat16 prefill runs 64-row wgmma tiles (``prefill_tile``), float32
prefill the f32 tile of ``csrc/attention_tile.cuh`` (``tile_block_q``).
Both take the Pallas kernels' ``window`` (sliding window, 0 = off),
``softcap`` (tanh cap on the raw scores, 0 = off) and ``scale``
(default D**-0.5), at D in {64, 128, 256}. A wrapper given CPU tensors
computes the plain version (gather through the table, then the masked
f32 softmax of ops/attention.py); given CUDA tensors it launches its
kernel or raises — there is no fallback between the two. The int8 pool
(``k_scales``, ``v_scales``) is not ported yet and raises.

A row parked at ``start >= MB*Bs`` (an idle slot of the full-batch
forward, whose output the engine discards) comes back as zeros from both
the kernels and the plain version, which do no work for it. The Pallas
kernels attend such a row over all ``nb`` blocks and return a finite
value nobody reads; live rows agree with them.
"""

import ctypes
from typing import Optional

import torch

from production_stack_tpu_torch import kernels
from production_stack_tpu_torch.models.kv import gather_view
from production_stack_tpu_torch.ops.attention import attention_with_cache

# decode windows have T <= this; longer chunks take the prefill kernel
DECODE_T_MAX = 8
HEAD_DIMS = (64, 128, 256)

# kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (the plain CPU path does not count); window_launches and
# softcap_launches count those of them made with the branch on
launch_counts = {"paged_decode_attention": 0, "paged_attention": 0}
window_launches = dict(launch_counts)
softcap_launches = dict(launch_counts)


def reset_launch_counts() -> None:
    for counts in (launch_counts, window_launches, softcap_launches):
        for name in counts:
            counts[name] = 0


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = kernels.load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention.argtypes = \
            [p] * 8 + [i] * 12 + [f, i, f, p]
        lib.paged_prefill_attention.argtypes = \
            [p] * 6 + [i] * 11 + [f, i, f, p]
        for fn in (lib.paged_decode_attention, lib.paged_prefill_attention):
            fn.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _refuse_flags(k_scales, v_scales) -> None:
    """int8 pools arrive with the quantization slice."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("int8 KV pools are not ported yet")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          starts: torch.Tensor, nb: int,
                          scale: Optional[float] = None, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain version of both kernels: gather the first nb blocks of
    every row through its table, then masked f32-softmax attention
    (sliding window and softcap as in ops/attention.py, 0 = off);
    parked rows (start >= MB*Bs) are zeros. Returns [B, T, H, D] in q's
    dtype."""
    T = q.shape[1]
    k_att = gather_view(k_pool, tables, nb)
    v_att = gather_view(v_pool, tables, nb)
    positions = starts.long()[:, None] + torch.arange(T, device=q.device)
    out = attention_with_cache(q, k_att, v_att, positions, scale=scale,
                               sliding_window=window,
                               logit_softcap=softcap)
    live = starts < tables.shape[1] * k_pool.shape[2]
    return torch.where(live[:, None, None, None], out,
                       torch.zeros((), dtype=out.dtype,
                                   device=out.device)).to(q.dtype)


def _check_cuda_args(q, k_pool, v_pool, tables, starts, nb):
    B, T, H, D = q.shape
    N, Hkv, Bs, Dk = k_pool.shape
    if not (q.is_cuda and k_pool.device == q.device
            and v_pool.device == q.device and tables.device == q.device
            and starts.device == q.device):
        raise ValueError("paged attention: every tensor must be on the "
                         "same CUDA device")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged attention kernels take float32 or "
                        f"bfloat16 q and pools of the same dtype (got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype})")
    if tables.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("tables and starts must be int32")
    if D not in HEAD_DIMS or Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"unsupported head dim / pool shape: q "
                         f"{tuple(q.shape)}, pool {tuple(k_pool.shape)} "
                         f"(D must be 64, 128 or 256)")
    if H % Hkv or tables.shape[0] != B or starts.shape != (B,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, Hkv {Hkv}, "
                         f"tables {tuple(tables.shape)}, starts "
                         f"{tuple(starts.shape)}")
    if not 1 <= nb <= tables.shape[1]:
        raise ValueError(f"nb={nb} must be in [1, MB={tables.shape[1]}]")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("starts", starts)):
        if not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")
    return B, T, H, D, N, Hkv, Bs


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().paged_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")


# the decode kernel's grid splits a row's nb blocks over at most this
# many thread blocks per (row, kv head); the merge gives each split a lane
MAX_SPLITS = 32


def decode_split_plan(nb: int) -> tuple:
    """(blocks per split, splits) of the decode kernel for nb blocks: at
    most MAX_SPLITS splits, the blocks shared out evenly, every block
    0..nb-1 in exactly one split. It depends on nb alone — the host never
    reads ``starts`` inside a decode window — so a captured decode step
    keeps it. At nb = 128 (Gemma-2's 8192-token bucket, Bs = 64) a split
    holds 4 blocks, and a 4,600-token row spreads over 18 splits per kv
    head: 144 thread blocks at 8 kv heads, more than an H100's 132 SMs."""
    bps = -(-nb // MAX_SPLITS)
    return bps, -(-nb // bps)


def prefill_tile(D: int) -> dict:
    """Geometry of the bfloat16 prefill kernel's tile at head dim D (as
    csrc/paged_attention.cu PrefillGeometry): 64 query rows (one wgmma M),
    K/V panels of 64 keys, a ring of 3 stages, and the shared memory it
    takes — Q and each stage's K and V panel, [64, D] bf16 each, plus the
    ring's mbarriers (128 bytes) and 1 KB to align the swizzled layout."""
    stages = 3
    return {"rows": 64, "keys": 64, "stages": stages,
            "smem_bytes": 128 + 1024 + 64 * D * 2 * (1 + 2 * stages)}


def tile_block_q(T: int, groups: int, D: int) -> int:
    """Query positions per tile of the f32 FMA tile of
    csrc/attention_tile.cuh, which every float32 kernel runs (prefill
    here, flash over a contiguous cache), never more than T: as many as
    keep the tile at 64 (position, head) rows, 32 at D = 256, so its
    shared memory (csrc tile_smem_floats, at Bs = 64) stays under the 227
    KB a block may use — 148,480 bytes at D = 128, 205,440 at D = 256."""
    rows = 64 if D <= 128 else 32
    return max(1, min(T, rows // groups))


def _launch(name: str, q, k_pool, v_pool, tables, starts, nb, scale,
            window, softcap) -> torch.Tensor:
    B, T, H, D, N, Hkv, Bs = _check_cuda_args(q, k_pool, v_pool, tables,
                                              starts, nb)
    if window < 0 or softcap < 0:
        raise ValueError(f"window={window} and softcap={softcap} must be "
                         f">= 0 (0 turns either off)")
    G = H // Hkv
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), starts.data_ptr(), out.data_ptr())
    shape = (B, T, H, Hkv, D, Bs, tables.shape[1], nb, N)
    tail = (float(scale), int(window), float(softcap), stream)
    if name == "paged_decode_attention":
        bps, splits = decode_split_plan(nb)
        # the splits' partials, f32: (m, l) then acc of every split row
        n_rows = B * Hkv * splits * T * G
        part = torch.empty(n_rows * (2 + D), dtype=torch.float32,
                           device=q.device)
        rc = _lib().paged_decode_attention(
            *head, part.data_ptr(), part.data_ptr() + n_rows * 2 * 4,
            _DTYPE_CODE[q.dtype], *shape, bps, splits, *tail)
    else:
        block_q = (prefill_tile(D)["rows"] // G if q.dtype == torch.bfloat16
                   else tile_block_q(T, G, D))
        rc = _lib().paged_prefill_attention(
            *head, _DTYPE_CODE[q.dtype], *shape, block_q, *tail)
    _raise_on(rc, name)
    launch_counts[name] += 1
    if window:
        window_launches[name] += 1
    if softcap:
        softcap_launches[name] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           starts: torch.Tensor, *, nb: int,
                           scale: Optional[float] = None,
                           k_scales=None, v_scales=None, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA of a short query window (T <= DECODE_T_MAX) over the
    paged pool. q [B,T,H,D]; k/v pool [N,Hkv,Bs,D]; tables [B,MB] int32;
    starts [B] int32; window/softcap 0 = off. See the module doc and
    csrc/paged_attention.cu."""
    _refuse_flags(k_scales, v_scales)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, tables, starts, nb,
                                     scale, window, softcap)
    if q.shape[1] > DECODE_T_MAX:
        raise ValueError(f"decode kernel takes T <= {DECODE_T_MAX} "
                         f"(got {q.shape[1]}); use paged_attention")
    return _launch("paged_decode_attention", q, k_pool, v_pool, tables,
                   starts, nb, scale, window, softcap)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    starts: torch.Tensor, *, nb: int,
                    scale: Optional[float] = None,
                    k_scales=None, v_scales=None, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA of a query chunk of any length over the paged pool
    (prefill), tiled over the query axis. Same arguments and result as
    paged_decode_attention."""
    _refuse_flags(k_scales, v_scales)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, tables, starts, nb,
                                     scale, window, softcap)
    return _launch("paged_attention", q, k_pool, v_pool, tables, starts,
                   nb, scale, window, softcap)
