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
axis over thread blocks (``decode_split_plan``); at bfloat16 q it packs
a block's T*G query rows into the M of tensor-core products
(``decode_tile``) and the last block of a row's splits to finish merges
them, so one wrapper call is one launch (the arrival counters are
allocated and zeroed once per device, ``_decode_counters``); a float32 q
keeps the f32 split kernel and a second merge launch. bfloat16 prefill
runs 64-row wgmma tiles (``prefill_tile``), float32 prefill the f32 tile
of ``csrc/attention_tile.cuh`` (``tile_block_q``).
Both take the Pallas kernels' ``window`` (sliding window, 0 = off),
``softcap`` (tanh cap on the raw scores, 0 = off) and ``scale``
(default D**-0.5), at D in {64, 128, 256}. A wrapper given CPU tensors
computes the plain version (gather through the table, then the masked
f32 softmax of ops/attention.py); given CUDA tensors it launches its
kernel or raises — there is no fallback between the two.

int8 pools (pallas_paged.py:91-93,128-131 and :343-346,381-383): int8
K/V with f32 ``k_scales``/``v_scales`` [N, Hkv, Bs], one per (token,
head), value = int8 * scale, for q in bf16 or f32. The kernels read the
int8 payload (half the bf16 pool's bytes) and its scales through the
same clamped table lookup, and dequantize in f32; the plain version
gathers through ``gather_view_q`` (f32 dequant, the product cast to q's
dtype). Scales go with an int8 pool and only with one: any other mix
raises, on both devices.

Under tensor parallelism (``paged_attention_sharded``, JAX
``pallas_paged.py:513-549``) each rank runs the same kernels on its own
heads: q of H / tp heads over a pool of Hkv / tp kv heads, the tables
and starts whole, with no collective. JAX's ``shard_map`` takes the
kernel shard-local on tp-only meshes only (``mesh_tp_only``); here an
ep slice is a full replica of the attention, so every ``tp x ep``
serving mesh keeps the kernels.

Where dp > 1 splits the pool's blocks (JAX falls back to its jnp
gathered view there, ``mesh_tp_only``), each layer's first nb blocks of
every row are assembled over dp into a copy of B * nb blocks
(models/kv.assemble_blocks), and the same kernels read the copy through
``assembled_tables`` with the same nb, starts, window, softcap and
scales: the decode split plan depends on nb alone, so every rank's
output is the tp-only engine's, bit for bit.

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
from production_stack_tpu_torch.models.kv import gather_view, gather_view_q
from production_stack_tpu_torch.ops.attention import attention_with_cache

# decode windows have T <= this; longer chunks take the prefill kernel
DECODE_T_MAX = 8
HEAD_DIMS = (64, 128, 256)

# kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (the plain CPU path does not count); window_launches,
# softcap_launches and int8_launches count those of them made with the
# window, the softcap or an int8 pool
launch_counts = {"paged_decode_attention": 0, "paged_attention": 0}
window_launches = dict(launch_counts)
softcap_launches = dict(launch_counts)
int8_launches = dict(launch_counts)
# launches per query-window length T for T in 2..VERIFY_T_MAX, the
# windows a speculative verify forward gives the kernels (spec + 1 for
# spec up to 16): {wrapper: {T: launches}}; verify_window_launches
# counts those of them made with the window
VERIFY_T_MAX = 17
verify_launches = {name: {} for name in launch_counts}
verify_window_launches = {name: {} for name in launch_counts}
# the decode kernel's T = 1 launches (decode steps) per batch B, the rows
# of q (a decode window's batch bucket): {B: {"launches", "window_launches",
# "int8_launches": n}}
step_launches = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, window_launches, softcap_launches,
                   int8_launches):
        for name in counts:
            counts[name] = 0
    for counts in (verify_launches, verify_window_launches):
        for by_t in counts.values():
            by_t.clear()
    step_launches.clear()


def launch_report() -> dict:
    """Copies of the launch counters (a parallel engine's worker ranks
    answer theirs through ParallelRunner.run_on_workers)."""
    return {"launches": dict(launch_counts),
            "window_launches": dict(window_launches),
            "softcap_launches": dict(softcap_launches),
            "int8_launches": dict(int8_launches),
            "verify_launches": {n: dict(c)
                                for n, c in verify_launches.items()},
            "verify_window_launches": {
                n: dict(c) for n, c in verify_window_launches.items()},
            "step_launches": {B: dict(c) for B, c in step_launches.items()}}


# element types of q / out (0, 1) and of the pool (0, 1, or 2 = int8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = kernels.load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention.argtypes = \
            [p] * 11 + [i] * 14 + [f, i, f, p]
        lib.paged_prefill_attention.argtypes = \
            [p] * 8 + [i] * 12 + [f, i, f, p]
        for fn in (lib.paged_decode_attention, lib.paged_prefill_attention):
            fn.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_scales(k_pool, v_pool, k_scales, v_scales) -> bool:
    """Whether the pool is int8 (then with both scales [N, Hkv, Bs] f32);
    raises on scales without an int8 pool and an int8 pool without
    them."""
    quant = k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8
    given = (k_scales is not None, v_scales is not None)
    if not quant:
        if any(given):
            raise ValueError("k_scales/v_scales go with an int8 pool only "
                             f"(got a {k_pool.dtype} pool)")
        return False
    if not all(given) or k_pool.dtype != v_pool.dtype:
        raise ValueError("an int8 pool needs int8 K and V and both "
                         "k_scales and v_scales")
    want = tuple(k_pool.shape[:3])
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be float32 {want} (got "
                             f"{t.dtype} {tuple(t.shape)})")
    return True


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          starts: torch.Tensor, nb: int,
                          scale: Optional[float] = None, window: int = 0,
                          softcap: float = 0.0, k_scales=None,
                          v_scales=None) -> torch.Tensor:
    """Plain version of both kernels: gather the first nb blocks of
    every row through its table (an int8 pool dequantized in f32 and
    cast to q's dtype), then masked f32-softmax attention (sliding
    window and softcap as in ops/attention.py, 0 = off); parked rows
    (start >= MB*Bs) are zeros. Returns [B, T, H, D] in q's dtype."""
    T = q.shape[1]
    if _check_scales(k_pool, v_pool, k_scales, v_scales):
        k_att = gather_view_q(k_pool, k_scales, tables, nb, dtype=q.dtype)
        v_att = gather_view_q(v_pool, v_scales, tables, nb, dtype=q.dtype)
    else:
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


def _check_cuda_args(q, k_pool, v_pool, tables, starts, nb, scales):
    B, T, H, D = q.shape
    N, Hkv, Bs, Dk = k_pool.shape
    tensors = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("tables", tables), ("starts", starts))
    tensors += tuple((n, t) for n, t in zip(("k_scales", "v_scales"),
                                            scales) if t is not None)
    if not (q.is_cuda and all(t.device == q.device for _, t in tensors)):
        raise ValueError("paged attention: every tensor must be on the "
                         "same CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_pool.dtype not in (q.dtype, torch.int8) \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged attention kernels take float32 or "
                        f"bfloat16 q and pools of the same dtype or int8 "
                        f"(got {q.dtype}, {k_pool.dtype}, {v_pool.dtype})")
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
    for name, t in tensors:
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


def decode_tile(D: int, R: int, int8: bool = False, bps: int = 4,
                Bs: int = 64) -> dict:
    """Geometry of the bfloat16-q decode kernel (as csrc/paged_attention.cu
    MmaDecodeGeometry) for R = T*G query rows per kv head at head dim D,
    splits of bps blocks of Bs keys: a block takes a row group of at most
    64 rows (row_groups of them, one grid slice each), m_tiles m16 tiles
    of it, warps_per_tile = 4, 2 or 1 warps sharing a tile's keys (every
    warps_per_tile-th 16-key chunk); K/V panels of `keys` keys (32 at D =
    256, else 64) in a ring of `stages` stages, as many as a split has
    panels up to 3 (one for a 512-token bucket's splits of one 64-key
    block, whose blocks then take a third of the shared memory), its rows
    padded by 16 bytes, with the int8 pool's scales, and after the loop
    the same bytes for the warps' (m, l, O) and the merge's weights; then
    Q, bf16, m_tiles * 16 padded rows, and the ring's mbarriers (64
    bytes). smem_bytes is the dynamic shared memory of a block."""
    keys, warps, group = (32 if D == 256 else 64), 4, 64
    stages = min(3, -(-bps * Bs // keys))
    row_groups = -(-R // group)
    m_tiles = -(-min(R, group) // 16)
    item = 1 if int8 else 2
    ring = stages * (2 * keys * (D * item + 16) + (2 * keys * 4 if int8
                                                   else 0))
    combine = warps * 16 * (D + 6) * 4
    merge = group * MAX_SPLITS * 4
    return {"keys": keys, "stages": stages, "row_groups": row_groups,
            "m_tiles": m_tiles,
            "warps_per_tile": {1: 4, 2: 2}.get(m_tiles, 1),
            "smem_bytes": max(ring, combine, merge)
            + m_tiles * 16 * (2 * D + 16) + 64}


# arrival counters of the decode kernel's merge, per device: int32 zeros,
# allocated once outside any graph capture; each call leaves them 0
_counters = {}
_COUNTERS_MIN = 1 << 16


def _decode_counters(device, n: int) -> torch.Tensor:
    """The device's arrival counters, at least n of them (one per
    (row, kv head, row group) of a bfloat16-q decode call). The last
    block of each group's splits resets its counter, so no memset is
    launched per call and a captured call replays; calls sharing the
    counters run one after another (one stream), as the engine's do."""
    index = torch.device(device).index
    buf = _counters.get(index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_decode_attention: the arrival "
                               "counters must be allocated before a CUDA "
                               "graph captures the call (call it once "
                               "outside the capture)")
        buf = _counters[index] = torch.zeros(max(n, _COUNTERS_MIN),
                                             dtype=torch.int32,
                                             device=device)
    return buf


def prefill_tile(D: int, int8: bool = False) -> dict:
    """Geometry of the bfloat16 prefill kernel's tile at head dim D (as
    csrc/paged_attention.cu PrefillGeometry): 64 query rows (one wgmma M),
    K/V panels of 64 keys, a ring of 3 stages, and the shared memory it
    takes — Q and each stage's K and V panel, [64, D] bf16 each, plus the
    ring's mbarriers (128 bytes) and 1 KB to align the swizzled layout;
    over an int8 pool (panels cast to bf16 as they land) also each
    stage's 64 K and 64 V scales, f32."""
    stages = 3
    return {"rows": 64, "keys": 64, "stages": stages,
            "smem_bytes": 128 + 1024 + 64 * D * 2 * (1 + 2 * stages)
            + (stages * 2 * 64 * 4 if int8 else 0)}


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
            window, softcap, k_scales, v_scales) -> torch.Tensor:
    B, T, H, D, N, Hkv, Bs = _check_cuda_args(q, k_pool, v_pool, tables,
                                              starts, nb,
                                              (k_scales, v_scales))
    if window < 0 or softcap < 0:
        raise ValueError(f"window={window} and softcap={softcap} must be "
                         f">= 0 (0 turns either off)")
    G = H // Hkv
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    quant = k_scales is not None
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            tables.data_ptr(), starts.data_ptr(), out.data_ptr())
    dtypes = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype])
    shape = (B, T, H, Hkv, D, Bs, tables.shape[1], nb, N)
    tail = (float(scale), int(window), float(softcap), stream)
    if name == "paged_decode_attention":
        bps, splits = decode_split_plan(nb)
        # the splits' partials, f32: (m, l) then acc of every split row,
        # acc at a 16-byte boundary (the kernel moves it as float4)
        n_rows = B * Hkv * splits * T * G
        ml = -(-n_rows * 2 // 4) * 4
        part = torch.empty(ml + n_rows * D, dtype=torch.float32,
                           device=q.device)
        # the merge's arrival counters (bf16 q; a float32 q has none),
        # one per (row, kv head, group of up to 64 query rows)
        counters = (_decode_counters(q.device, B * Hkv * -(-T * G // 64))
                    if q.dtype == torch.bfloat16 else None)
        rc = _lib().paged_decode_attention(
            *head, part.data_ptr(), part.data_ptr() + ml * 4,
            None if counters is None else counters.data_ptr(),
            *dtypes, *shape, bps, splits,
            0 if counters is None else counters.numel(), *tail)
    else:
        block_q = (prefill_tile(D)["rows"] // G if q.dtype == torch.bfloat16
                   else tile_block_q(T, G, D))
        rc = _lib().paged_prefill_attention(
            *head, *dtypes, *shape, block_q, *tail)
    _raise_on(rc, name)
    launch_counts[name] += 1
    if window:
        window_launches[name] += 1
    if softcap:
        softcap_launches[name] += 1
    if quant:
        int8_launches[name] += 1
    if 2 <= T <= VERIFY_T_MAX:
        for counts in ((verify_launches, verify_window_launches) if window
                       else (verify_launches,)):
            counts[name][T] = counts[name].get(T, 0) + 1
    if T == 1:
        step = step_launches.setdefault(B, dict.fromkeys(
            ("launches", "window_launches", "int8_launches"), 0))
        step["launches"] += 1
        step["window_launches"] += bool(window)
        step["int8_launches"] += quant
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           starts: torch.Tensor, *, nb: int,
                           scale: Optional[float] = None,
                           k_scales=None, v_scales=None, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA of a short query window (T <= DECODE_T_MAX) over the
    paged pool. q [B,T,H,D]; k/v pool [N,Hkv,Bs,D]; tables [B,MB] int32;
    starts [B] int32; window/softcap 0 = off; k_scales/v_scales [N,
    Hkv, Bs] f32 with an int8 pool. See the module doc and
    csrc/paged_attention.cu."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, tables, starts, nb,
                                     scale, window, softcap, k_scales,
                                     v_scales)
    if q.shape[1] > DECODE_T_MAX:
        raise ValueError(f"decode kernel takes T <= {DECODE_T_MAX} "
                         f"(got {q.shape[1]}); use paged_attention")
    _check_scales(k_pool, v_pool, k_scales, v_scales)
    return _launch("paged_decode_attention", q, k_pool, v_pool, tables,
                   starts, nb, scale, window, softcap, k_scales, v_scales)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    starts: torch.Tensor, *, nb: int,
                    scale: Optional[float] = None,
                    k_scales=None, v_scales=None, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA of a query chunk of any length over the paged pool
    (prefill), tiled over the query axis. Same arguments and result as
    paged_decode_attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, tables, starts, nb,
                                     scale, window, softcap, k_scales,
                                     v_scales)
    _check_scales(k_pool, v_pool, k_scales, v_scales)
    return _launch("paged_attention", q, k_pool, v_pool, tables, starts,
                   nb, scale, window, softcap, k_scales, v_scales)


def assembled_tables(B: int, nb: int, MB: int,
                     device) -> torch.Tensor:
    """Tables [B, MB] int32 over an assembled copy of B * nb blocks
    (models/kv.assemble_blocks): row b's j-th block is b * nb + j, and
    the columns past nb repeat its last one, so the tables keep the
    pool's width MB, from which the kernels and the plain version read
    the parked-row rule (start >= MB * Bs)."""
    j = torch.arange(MB, device=device).clamp(max=nb - 1)
    rows = torch.arange(B, device=device)[:, None] * nb
    return (rows + j[None]).to(torch.int32)


def paged_attention_sharded(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, tables: torch.Tensor,
                            starts: torch.Tensor, shard, *, nb: int,
                            num_heads: int, num_kv_heads: int,
                            **kw) -> torch.Tensor:
    """One tp rank's paged attention (parallel/mesh.Shard `shard`): its
    H / tp query heads over its Hkv / tp pool heads, through the decode
    kernel for T <= DECODE_T_MAX and the prefill kernel above, as the
    unsharded forward chooses. num_heads / num_kv_heads: the model's
    whole counts, which the rank's shapes are checked against."""
    tp = shard.tp
    if (num_heads % tp or num_kv_heads % tp or q.shape[2] != num_heads // tp
            or k_pool.shape[1] != num_kv_heads // tp):
        raise ValueError(f"tp rank {shard.tp_rank}/{tp}: q heads "
                         f"{q.shape[2]} and pool heads {k_pool.shape[1]} "
                         f"are not {num_heads} / {num_kv_heads} over tp")
    fn = (paged_decode_attention if q.shape[1] <= DECODE_T_MAX
          else paged_attention)
    return fn(q, k_pool, v_pool, tables, starts, nb=nb, **kw)
