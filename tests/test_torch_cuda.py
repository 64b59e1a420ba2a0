"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no interpret mode, so these skip where there is
no NVIDIA GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances as in chip_smoke.py: float32 2e-5 (softmax summed in another
order); bfloat16 3e-2 (bf16 outputs up to ~4, and the plain version
rounds the probabilities to bf16 before the value product where the
kernel keeps them in float32). Over an int8 pool the kernels are held
against the plain version in float32 (q upcast exactly), whose f32
dequantization is the kernels' and the Pallas int8 branch's.
"""

import pytest
import torch

from production_stack_tpu_torch.models.kv import (quantize_chunk, write_chunk,
                                                  write_chunk_q)
from production_stack_tpu_torch.ops import flash_attention as fa
from production_stack_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(dev, T, G, D, dtype, lens=(70, 5, 300), seed=0, Bs=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv, B = 2, len(lens) + 1
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    # the last row is parked past the virtual capacity MB*Bs
    starts = torch.tensor(list(lens) + [MB * Bs + 1], dtype=torch.int32,
                          device=dev)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    write_chunk(k, rnd(B, T, Hkv, D), tables, pos)
    write_chunk(v, rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return rnd(B, T, Hkv * G, D), k, v, tables, starts, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,window,softcap", [
    (pa.paged_decode_attention, 1, 4, 128, 64, 0, 0.0),
    (pa.paged_decode_attention, 8, 8, 64, 64, 0, 0.0),
    (pa.paged_attention, 9, 4, 128, 64, 0, 0.0),
    (pa.paged_attention, 130, 8, 64, 64, 0, 0.0),
    # Gemma-2-9B: D = 256 with G = 2
    (pa.paged_decode_attention, 8, 2, 256, 64, 0, 0.0),
    (pa.paged_attention, 100, 2, 256, 64, 0, 0.0),
    # a window of 40 over blocks of 16, rows well past it
    (pa.paged_decode_attention, 5, 4, 128, 16, 40, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, 40, 0.0),
    # a softcap of 50 on raw scores of about +-100 (q x 30)
    (pa.paged_decode_attention, 1, 2, 256, 64, 0, 50.0),
    (pa.paged_attention, 64, 2, 256, 64, 100, 50.0),
])
def test_kernel_matches_plain_version(cuda, fn, T, G, D, Bs, window,
                                      softcap, dtype):
    q, k, v, tables, starts, nb = _case(cuda, T, G, D, dtype, Bs=Bs)
    if softcap:
        # the softmax sits on a few keys: V at half scale keeps the
        # output within the +-4 the bf16 tolerance assumes
        q, v = (q.float() * 30).to(dtype), (v.float() * 0.5).to(dtype)
    name = fn.__name__
    before = pa.launch_counts[name]
    got = fn(q, k, v, tables, starts, nb=nb, window=window,
             softcap=softcap)
    torch.cuda.synchronize()
    assert pa.launch_counts[name] == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb, D ** -0.5,
                                    window, softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


# The redesigned kernels' edges: decode splits the KV axis (many splits
# when a row of 72 blocks and one of 1 block share a batch; T = 8 with a
# split boundary inside the window; Gemma-2's window of 4096 at Bs = 64);
# bf16 prefill runs 64-row wgmma tiles (G in {2, 4, 8}, T not a multiple
# of the tile), f32 prefill the f32 tile.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,lens,window,softcap", [
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 10, 2000), 0, 0.0),
    (pa.paged_decode_attention, 8, 4, 128, 16, (517, 300, 45), 100, 0.0),
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 1000, 57), 4096,
     50.0),
    (pa.paged_attention, 96, 2, 256, 64, (4550, 4100, 300), 4096, 50.0),
    (pa.paged_attention, 100, 2, 256, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 37, 8, 64, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, (517, 300, 45), 40, 0.0),
])
def test_redesigned_kernels_match_plain_version(cuda, fn, T, G, D, Bs, lens,
                                                window, softcap, dtype):
    q, k, v, tables, starts, nb = _case(cuda, T, G, D, dtype, lens=lens,
                                        Bs=Bs)
    if softcap:
        q, v = (q.float() * 30).to(dtype), (v.float() * 0.5).to(dtype)
    name = fn.__name__
    before = pa.launch_counts[name]
    got = fn(q, k, v, tables, starts, nb=nb, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert pa.launch_counts[name] == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb, D ** -0.5,
                                    window, softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()   # the parked row


# bfloat16 runs the wgmma kernel on 128-row tiles, float32 the f32 tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,G,D,starts", [
    # G in {1, 3, 4, 8} at D = 128 and D in {64, 256} at G = 2, T * G off
    # the 128-row tile, S off the K/V panel; (0, 100, 180) has a row
    # whose positions pass S - 1; 1000 x 4 rows make 192 tiles, more than
    # an H100 has SMs
    (300, 700, 1, 128, (0, 250, 400)),
    (1000, 1100, 4, 128, (0, 50, 100)),
    (50, 200, 3, 128, (0, 100, 163)),
    (37, 200, 4, 128, (0, 100, 180)),
    (37, 200, 8, 128, (0, 100, 163)),
    (37, 200, 2, 64, (0, 100, 180)),
    (300, 700, 2, 256, (0, 250, 400)),
    (37, 200, 2, 256, (0, 100, 180)),
    (1, 130, 4, 128, (129, 64, 0)),
    # S < 64: a single ragged panel
    (20, 40, 4, 128, (0, 10, 30)),
])
def test_flash_kernel_matches_plain_version(cuda, T, S, G, D, starts,
                                            dtype):
    """T and S not multiples of the query tile and the K/V panel."""
    g = torch.Generator(device=cuda).manual_seed(T + S + D)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    B, Hkv = len(starts), 2
    q, k, v = rnd(B, T, Hkv * G, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    before = fa.launch_counts["flash_attention_with_cache"]
    got = fa.flash_attention_with_cache(q, k, v, starts)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_with_cache"] == before + 1
    want = fa.flash_attention_plain(q, k, v, starts)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def _case8(dev, T, G, D, lens, seed, Bs, dtype):
    """_case over an int8 pool: random f32 K/V quantized per (token,
    head) and the chunk's own K/V written by write_chunk_q; q in
    `dtype`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, tables, starts, nb = _case(dev, T, G, D, torch.float32,
                                        lens=lens, seed=seed, Bs=Bs)
    (k8, ks), (v8, vs) = quantize_chunk(k), quantize_chunk(v)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    for pool, scales in ((k8, ks), (v8, vs)):
        new = torch.randn((len(lens) + 1, T, k.shape[1], D), generator=g,
                          device=dev)
        write_chunk_q(pool, scales, new, tables, pos)
    return q.to(dtype), k8, v8, ks, vs, tables, starts, nb


# the int8 pool's branches of both kernels, q in bf16 and f32: the split
# decode, the wgmma prefill (bf16 q: panels cast to bf16 as they land,
# scales on the accumulators) and the f32 tile (f32 q), with a window,
# a softcap and D = 256 (Bs = 16: panels cross blocks)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,lens,window,softcap", [
    (pa.paged_decode_attention, 1, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_decode_attention, 8, 8, 64, 16, (517, 300, 45), 0, 0.0),
    (pa.paged_decode_attention, 5, 4, 128, 16, (517, 300, 45), 40, 0.0),
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 10, 2000), 0, 0.0),
    (pa.paged_decode_attention, 8, 2, 256, 64, (70, 5, 300), 0, 50.0),
    (pa.paged_attention, 9, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 100, 2, 256, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, (517, 300, 45), 40, 0.0),
    (pa.paged_attention, 37, 8, 64, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 64, 2, 256, 64, (70, 5, 300), 100, 50.0),
])
def test_int8_kernel_matches_plain_version(cuda, fn, T, G, D, Bs, lens,
                                           window, softcap, dtype):
    q, k8, v8, ks, vs, tables, starts, nb = _case8(
        cuda, T, G, D, lens, T + D + Bs, Bs, dtype)
    if softcap:
        q, vs = (q.float() * 30).to(dtype), vs * 0.5
    name = fn.__name__
    before = (pa.launch_counts[name], pa.int8_launches[name])
    got = fn(q, k8, v8, tables, starts, nb=nb, window=window,
             softcap=softcap, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert (pa.launch_counts[name], pa.int8_launches[name]) == (
        before[0] + 1, before[1] + 1)
    # the plain version in f32 on the same (exactly upcast) q: the kernels
    # dequantize in f32 as the Pallas int8 branch does, where the plain
    # version at bf16 q rounds the dequantized K/V to bf16 (which at the
    # softcap case's scores of ~+-100 alone moves outputs by ~3e-2)
    want = pa.paged_attention_plain(q.float(), k8, v8, tables, starts, nb,
                                    D ** -0.5, window, softcap, ks, vs)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()   # the parked row


# ------------------------------------- the tensor-core decode kernel (bf16 q)

# (nb, rows' starts) over blocks of 16: one split (nb 1, so every row
# ends mid-panel) and 32 splits (nb 64, two blocks a split). Each set has
# a row whose window lies wholly past the nb blocks read (fully masked:
# the kernel's finite 0, where the plain version averages the masked
# keys), with window 20, and a parked row last.
_SPLIT_ROWS = {1: (1, (0, 5, 40)), 32: (64, (1000, 3, 400, 1050))}


def _decode_case(dev, T, G, D, nb, lens, kv, seed, Bs=16):
    """q [B, T, 2G, D] bf16 (2 kv heads) over a pool of Bs-token blocks
    (bf16, or int8 with scales), MB = nb + 3 so rows may start past the nb
    blocks read; the last row parked. Returns q, k, v, scales (dict),
    tables, starts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv, B = 2, len(lens) + 1
    MB = nb + 3
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    starts = torch.tensor(list(lens) + [MB * Bs + 2], dtype=torch.int32,
                          device=dev)
    q = rnd(B, T, Hkv * G, D).to(torch.bfloat16)
    if kv == "int8":
        (k8, ks), (v8, vs) = quantize_chunk(k), quantize_chunk(v)
        return q, k8, v8, dict(k_scales=ks, v_scales=vs), tables, starts
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), {}, tables, starts


def _fully_masked(starts, T, nb, Bs, MB, window):
    """[B, T] bool: live (not parked) queries with no key among the nb
    blocks read inside their window."""
    p = starts.long()[:, None] + torch.arange(T, device=starts.device)
    lo = (p - window + 1).clamp(min=0) if window else torch.zeros_like(p)
    return (starts[:, None] < MB * Bs) & (lo > torch.clamp(p, max=nb * Bs - 1))


def _check_decode(dev, T, G, D, nb, lens, kv, window, cap, seed, Bs=16):
    """One bf16-q decode call of _decode_case, plain or with `window` and
    a softcap `cap` (q x 30, V x 0.5), against the plain version (over an
    int8 pool in f32): finite, the parked row and every fully masked row
    exactly 0 (the plain version averages the masked keys there), a
    fully masked row present exactly where there is a window, the rest
    within the bf16 tolerance."""
    q, k, v, sc, tables, starts = _decode_case(dev, T, G, D, nb, lens, kv,
                                               seed, Bs)
    if cap:
        q = (q.float() * 30).to(torch.bfloat16)
        if sc:
            sc["v_scales"] = sc["v_scales"] * 0.5
        else:
            v = (v.float() * 0.5).to(torch.bfloat16)
    got = pa.paged_decode_attention(q, k, v, tables, starts, nb=nb,
                                    window=window, softcap=cap, **sc)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q.float() if sc else q, k, v, tables,
                                    starts, nb, D ** -0.5, window, cap, **sc)
    dead = _fully_masked(starts, T, nb, Bs, tables.shape[1], window)
    case = (T, kv, window, cap)
    assert torch.isfinite(got).all(), case
    assert (got[-1] == 0).all(), case   # the parked row
    assert (got[dead] == 0).all(), case
    assert bool(dead.any()) == bool(window), case
    err = (got.float() - want.float())[~dead].abs().max().item()
    assert err <= TOL[torch.bfloat16], (case, err)


@pytest.mark.parametrize("splits", [1, 32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
def test_decode_kernel_grid_matches_plain_version(cuda, G, D, splits):
    """T = 1..8 over a bf16 and an int8 pool, each plain and with a
    window of 20 and a softcap of 50: one split or 32, rows ending
    mid-panel, a fully masked row and a parked row (_check_decode)."""
    nb, lens = _SPLIT_ROWS[splits]
    assert pa.decode_split_plan(nb)[1] == splits
    seed = 0
    for T in range(1, 9):
        for kv in ("bfloat16", "int8"):
            for window, cap in ((0, 0.0), (20, 50.0)):
                seed += 1
                _check_decode(cuda, T, G, D, nb, lens, kv, window, cap, seed)


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("nb", [8, 64, 96, 128])
def test_decode_kernel_multi_panel_splits_match_plain_version(cuda, nb, D,
                                                              G):
    """Blocks of 64 keys, as the engine's pools: a split of bps = nb / 32
    blocks (1 at nb 8, 2, 3, 4) runs bps panels at D = 128 (64 keys a
    panel) and 2 * bps at D = 256 (32 keys), so the ring runs 1..3
    stages and reuses its stages past 3 panels; at D = 256 with one m16
    tile (G = 2) warps 2 and 3 own no chunk of the first panel, and at
    T*G = 32 (G = 8, T = 4) two tiles' warps own chunks of different
    panels. T = 1 and 4, bf16 and int8 pools, plain and with a window of
    100 and a softcap of 50; rows of a whole bucket less 10 keys, 1,000
    (300 at nb 8), 3, and past the nb blocks read (fully masked with the
    window), and a parked row (_check_decode)."""
    Bs = 64
    bps, splits = pa.decode_split_plan(nb)
    assert bps == -(-nb // 32) and splits * bps >= nb
    lens = (nb * Bs - 10, 300 if nb == 8 else 1000, 3, nb * Bs + 120)
    seed = 100
    for T in (1, 4):
        for kv in ("bfloat16", "int8"):
            for window, cap in ((0, 0.0), (100, 50.0)):
                seed += 1
                _check_decode(cuda, T, G, D, nb, lens, kv, window, cap, seed,
                              Bs)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_kernel_past_one_row_group_matches_plain_version(cuda, kv):
    """G = 16 at T = 8: 128 query rows per kv head, two row groups of 64
    (two grid slices, each merged on its own), one launch."""
    nb, lens = _SPLIT_ROWS[32]
    q, k, v, sc, tables, starts = _decode_case(cuda, 8, 16, 128, nb, lens,
                                               kv, 7)
    got = pa.paged_decode_attention(q, k, v, tables, starts, nb=nb, **sc)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q.float() if sc else q, k, v, tables,
                                    starts, nb, 128 ** -0.5, 0, 0.0, **sc)
    assert pa.decode_tile(128, 8 * 16)["row_groups"] == 2
    assert (got.float() - want.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("splits", [1, 32])
def test_decode_row_at_t1_is_bit_equal_inside_a_t4_window(cuda, splits, kv):
    """At G = 4 a T = 1 call's rows and a T = 4 window's (16 rows) share
    one m16 tile and one warp plan, and a row's arithmetic does not
    depend on the others: at the same nb, query 0 of the window equals
    the single query bit for bit."""
    nb, lens = _SPLIT_ROWS[splits]
    # row 14 ends its T = 4 window in the next block (the same split)
    lens = (lens[0], 14) + lens[2:]
    q4, k, v, sc, tables, starts = _decode_case(cuda, 4, 4, 128, nb, lens,
                                                kv, 11)
    q1 = q4[:, :1].contiguous()
    one = pa.paged_decode_attention(q1, k, v, tables, starts, nb=nb, **sc)
    four = pa.paged_decode_attention(q4, k, v, tables, starts, nb=nb, **sc)
    torch.cuda.synchronize()
    assert torch.equal(one[:, 0], four[:, 0])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_kernel_calls_are_bit_equal(cuda, kv):
    """Whichever split arrives last merges the splits in split order: two
    calls give the same bits (32 splits, T = 4, a window)."""
    nb, lens = _SPLIT_ROWS[32]
    q, k, v, sc, tables, starts = _decode_case(cuda, 4, 4, 128, nb, lens,
                                               kv, 13)
    a = pa.paged_decode_attention(q, k, v, tables, starts, nb=nb,
                                  window=300, **sc)
    b = pa.paged_decode_attention(q, k, v, tables, starts, nb=nb,
                                  window=300, **sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("T,G,splits,kv", [
    (1, 4, 1, "bfloat16"), (1, 4, 32, "bfloat16"), (4, 4, 32, "int8"),
    (8, 8, 32, "bfloat16"), (8, 16, 32, "int8")])
def test_decode_call_launches_one_kernel(cuda, T, G, splits, kv):
    """Under torch.profiler a bf16-q call is one device kernel, the
    decode kernel itself: no merge launch, no memset of the counters.
    The traced call follows a traced and discarded one (the profiler's
    warm-up cycle), as a trace may lose its first device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    nb, lens = _SPLIT_ROWS[splits]
    q, k, v, sc, tables, starts = _decode_case(cuda, T, G, 128, nb, lens,
                                               kv, 17)
    pa.paged_decode_attention(q, k, v, tables, starts, nb=nb, **sc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            pa.paged_decode_attention(q, k, v, tables, starts, nb=nb, **sc)
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "paged_decode_mma_kernel" in names[0], names


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, starts, nb = _case(cuda, 1, 4, 128, torch.float32)
    scales = torch.ones(k.shape[:3], device=cuda)
    with pytest.raises(ValueError, match="int8"):
        pa.paged_attention(q, k, v, tables, starts, nb=nb,
                           k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError, match="int8"):
        pa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                                  tables, starts, nb=nb)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), tables, starts,
                                  nb=nb)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), starts, nb=nb)
    with pytest.raises(ValueError, match="T <= 8"):
        pa.paged_decode_attention(q.repeat(1, 9, 1, 1), k, v, tables,
                                  starts, nb=nb)


# ------------------------------------------------------------ logit shaping

def _shaping_inputs(dev, B=4, V=512, seed=0):
    """Random logits, counts, prompt membership and shaping params."""
    import dataclasses
    from production_stack_tpu_torch.engine import sampler
    g = torch.Generator().manual_seed(seed)
    sp = sampler.SamplingParams.filled(B, device="cpu")
    bias_ids = torch.full_like(sp.bias_ids, -1)
    bias_ids[:, :6] = torch.randint(0, V, (B, 6), generator=g,
                                    dtype=torch.int32)
    stop_ids = torch.full_like(sp.stop_ids, -1)
    stop_ids[:, :2] = torch.randint(0, V, (B, 2), generator=g,
                                    dtype=torch.int32)
    sp = dataclasses.replace(
        sp, presence=torch.rand(B, generator=g) * 2,
        frequency=torch.rand(B, generator=g) - 0.5,
        repetition=torch.rand(B, generator=g) + 0.5,
        min_tokens=torch.tensor([0, 3, 9, 1], dtype=torch.int32)[:B],
        bias_ids=bias_ids, bias_vals=torch.randn(sp.bias_vals.shape,
                                                 generator=g) * 5,
        stop_ids=stop_ids)
    logits = torch.randn(B, V, generator=g) * 4
    counts = torch.randint(0, 3, (B, V), generator=g, dtype=torch.int32) \
        * (torch.rand(B, V, generator=g) < 0.1)
    seen = torch.rand(B, V, generator=g) < 0.1
    out_len = torch.tensor([0, 2, 5, 1], dtype=torch.int32)[:B]
    move = lambda x: x.to(dev)
    return (move(logits), sampler.SamplingParams(
        **{f.name: move(getattr(sp, f.name))
           for f in dataclasses.fields(sp)}),
        move(counts.to(torch.int32)), move(seen), move(out_len))


def test_adjust_logits_on_the_card_equals_the_cpu(cuda):
    from production_stack_tpu_torch.engine.sampler import adjust_logits
    got = adjust_logits(*_shaping_inputs(cuda), eos_id=257)
    want = adjust_logits(*_shaping_inputs("cpu"), eos_id=257)
    assert (got.cpu() - want).abs().max().item() <= 1e-6


def _tiny_runner(dev, B=4):
    """debug-tiny at head dim 64 (the kernels take 64, 128 and 256) in
    float32, weights from seed 0 made on the CPU, in a runner on
    `dev`."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_config
    mcfg = dataclasses.replace(get_config("debug-tiny"), head_dim=64,
                               dtype=torch.float32)
    params = llama.init_params(mcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    moved = llama.Llama(mcfg, device=dev)
    moved.load_state_dict(params.state_dict())
    cfg = EngineConfig(model="debug-tiny", dtype="float32",
                       kv_dtype="float32", max_model_len=256,
                       max_num_seqs=B, kv_block_size=16, device=dev)
    return ModelRunner(mcfg, cfg, params=moved)


def _shaped_window(dev, B=4, W=8):
    """The runner of _tiny_runner on `dev`: one 8-token prefill per row,
    then a decode window of W greedy steps with shaping and top-5 on
    every row. Returns (ids, logprobs, top ids, top logprobs, counts) on
    the CPU."""
    import dataclasses

    import numpy as np
    runner = _tiny_runner(dev, B)
    cfg = runner.engine_cfg
    runner.eos_id = 257
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    _, sp, counts, seen, _ = _shaping_inputs(dev, B=B)
    sp = dataclasses.replace(sp, prompt_len=torch.full(
        (B,), 8, dtype=torch.int32, device=dev))
    toks = np.array([[256, 5, 6, 7, 8, 9, 10, 11]] * B, np.int32)
    runner.prefill(toks, np.zeros(B, np.int32), np.full(B, 8, np.int32),
                   sp, 256, greedy=True)
    runner.set_decode_state(np.full(B, 12, np.int32),
                            np.full(B, 8, np.int32))
    runner.set_penalty_state(counts.cpu().numpy(), seen.cpu().numpy())
    ids, lps, tops = runner.decode(sp, steps=W, kv_len=256, greedy=True,
                                   penalized=True, topk=5)
    return [t.cpu() for t in (ids, lps, tops[0], tops[1],
                              runner._dec_counts)]


def test_shaped_decode_window_on_the_card_equals_the_cpu(cuda):
    """The shaped window on the card (the paged kernels) and on the CPU
    (their plain versions): the same ids, top-5 ids and counts, the
    logprobs and alternatives to 1e-4 (float32 attention summed in
    another order, 2e-5 per call)."""
    c, g = _shaped_window("cpu"), _shaped_window(cuda)
    assert torch.equal(c[0], g[0]) and torch.equal(c[2], g[2])
    assert torch.equal(c[4], g[4])
    assert (c[1] - g[1]).abs().max().item() <= 1e-4
    assert (c[3] - g[3]).abs().max().item() <= 1e-4


def test_out_of_vocab_prompt_logprobs_on_the_card_equal_the_cpu(cuda):
    """Prompt logprobs with ids outside the vocabulary (V = 512) on the
    card, through the paged kernels: no device assert, NaN where a
    target lies outside [-V, V) as on the CPU, the rest to 1e-4."""
    import numpy as np
    row = [1, 612, -5, -612, 511, -512, 2 ** 30, 3]
    toks = np.array([row, [256, 7, 8, 9, 10, 11, 12, 13]], np.int32)
    c = _tiny_runner("cpu", 2).prompt_logprobs(toks)
    g = _tiny_runner(cuda, 2).prompt_logprobs(toks).cpu()
    assert torch.equal(c.isnan(), g.isnan())
    assert c.isnan().sum().item() == 3
    assert torch.allclose(c, g, rtol=0, atol=1e-4, equal_nan=True)


def _verify_window(dev, spec, B=4, steps=4):
    """The runner of _tiny_runner on `dev`: one prefill of four prompts
    (two repetitive, one short, one of 250 tokens whose macro-steps run
    into max_model_len 256), then a speculative window of `steps`
    macro-steps of `spec` drafts with the third row declining to
    speculate. Returns (ids, logprobs, counts, history) on the CPU."""
    import numpy as np

    from production_stack_tpu_torch.engine import sampler
    runner = _tiny_runner(dev, B)
    cfg = runner.engine_cfg
    S, MB = cfg.max_model_len, cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    rng = np.random.default_rng(1)
    base = rng.integers(1, 40, 10).tolist()
    prompts = [base * 4, (base[3:] + base[:3]) * 4,
               rng.integers(0, 512, 24).tolist(), (base * 25)[:250]]
    toks = np.zeros((B, 250), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    sp = sampler.SamplingParams.filled(B, temperature=0.0, device=dev)
    first, _, _ = runner.prefill(toks, np.zeros(B, np.int32), lens, sp, S,
                                 greedy=True)
    first = first.cpu().numpy()
    hist = np.zeros((B, S), np.int32)
    for b, p in enumerate(prompts):
        hist[b, :len(p)] = p
        hist[b, len(p)] = first[b]
    runner.set_decode_state(first, lens, history=hist)
    ids, lps, counts, _ = runner.decode_spec(
        sp, steps=steps, kv_len=S, spec=spec,
        spec_ok=np.array([True, True, False, True]), greedy=True)
    return [t.cpu() for t in (ids, lps, counts, runner._dec_hist)]


@pytest.mark.parametrize("spec", [3, 8])
def test_verify_window_on_the_card_equals_the_cpu(cuda, spec):
    """Speculative verify windows through the paged kernels at
    T = spec + 1 (the decode kernel at 4, the prefill kernel at 9),
    a row running past max_model_len among them: the same tokens,
    accepted counts and history as the plain versions on the CPU, the
    logprobs to 1e-4, and the kernel launched at that T."""
    pa.reset_launch_counts()
    g = _verify_window(cuda, spec)
    name = ("paged_decode_attention" if spec + 1 <= pa.DECODE_T_MAX
            else "paged_attention")
    assert pa.verify_launches[name].get(spec + 1, 0) > 0
    c = _verify_window("cpu", spec)
    assert torch.equal(c[0], g[0]) and torch.equal(c[2], g[2])
    assert torch.equal(c[3], g[3])
    assert (c[1] - g[1]).abs().max().item() <= 1e-4
    assert c[2][:2].sum().item() > 2 * c[2].shape[1]   # drafts accepted
    assert (c[2][2] == 1).all()


def _adapter_window(dev, B=4, W=6):
    """The runner of _tiny_runner on `dev` with two adapters on all seven
    targets (drawn on the CPU, rank 4) and rows on adapters [0, 1, 2, 1]:
    one prefill of four prompts, then a greedy decode window of W steps.
    Returns (first ids, window ids, logprobs) on the CPU."""
    import dataclasses

    import numpy as np

    from production_stack_tpu_torch.engine import sampler
    from production_stack_tpu_torch.models import lora
    runner = _tiny_runner(dev, B)
    mcfg, cfg = runner.model_cfg, runner.engine_cfg
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=(
        "q", "k", "v", "o", "gate", "up", "down"))
    gen = torch.Generator().manual_seed(11)
    ads = [lora.random_adapter(mcfg, lcfg, gen, device="cpu")
           for _ in range(2)]
    stack = lora.stack_adapters(mcfg, lcfg, ads, device="cpu")
    runner.set_lora({n: {k: t.to(dev) for k, t in ab.items()}
                     for n, ab in stack.items()}, lcfg.scaling)
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    sp = sampler.SamplingParams.filled(B, temperature=0.0, device=dev)
    sp = dataclasses.replace(sp, adapter=torch.tensor(
        [0, 1, 2, 1], dtype=torch.int32, device=dev))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (B, 20)).astype(np.int32)
    toks[3] = toks[1]
    first, _, _ = runner.prefill(toks, np.zeros(B, np.int32),
                                 np.full(B, 20, np.int32), sp, 256,
                                 greedy=True)
    runner.set_decode_state(first.cpu().numpy(), np.full(B, 20, np.int32))
    ids, lps, _ = runner.decode(sp, steps=W, kv_len=256, greedy=True)
    return first.cpu(), ids.cpu(), lps.cpu()


def test_mixed_adapter_batch_on_the_card_equals_the_cpu(cuda):
    """A batch mixing the base model and two adapters through the paged
    kernels on the card: the same greedy ids as the plain versions on
    the CPU, logprobs to 1e-4 (float32), both kernels launched; rows 1
    and 3 share prompt and adapter, so their streams are equal, and the
    adapters give streams of their own."""
    pa.reset_launch_counts()
    g = _adapter_window(cuda)
    assert pa.launch_counts["paged_attention"] > 0
    assert pa.launch_counts["paged_decode_attention"] > 0
    c = _adapter_window("cpu")
    assert torch.equal(c[0], g[0]) and torch.equal(c[1], g[1])
    assert (c[2] - g[2]).abs().max().item() <= 1e-4
    assert torch.equal(g[1][1], g[1][3])
    assert not torch.equal(g[1][1], g[1][2])


# ------------------------- MHA, seven groups, rolled tables and the MoE

def _geometry_case(dev, T, Hkv, G, D, dtype, lens, Bs=64, seed=0):
    """_case with Hkv kv heads: B = len(lens) + 1 rows, the last parked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens) + 1
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    starts = torch.tensor(list(lens) + [MB * Bs + 1], dtype=torch.int32,
                          device=dev)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    write_chunk(k, rnd(B, T, Hkv, D), tables, pos)
    write_chunk(v, rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return rnd(B, T, Hkv * G, D), k, v, tables, starts, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,Hkv,G,D", [
    # G = 1: Qwen1.5-MoE (16 kv heads, D = 128), Gemma-7B (D = 256); the
    # bf16 prefill tile holds 64 positions of one head
    (pa.paged_decode_attention, 1, 16, 1, 128),
    (pa.paged_decode_attention, 8, 16, 1, 128),
    (pa.paged_attention, 130, 16, 1, 128),
    (pa.paged_decode_attention, 1, 4, 1, 256),
    (pa.paged_attention, 100, 4, 1, 256),
    # G = 7: Qwen2-7B; 63 live rows of the prefill tile (block_q 9)
    (pa.paged_decode_attention, 1, 4, 7, 128),
    (pa.paged_decode_attention, 8, 4, 7, 128),
    (pa.paged_attention, 9, 4, 7, 128),
    (pa.paged_attention, 100, 4, 7, 128),
])
def test_kernels_at_mha_and_seven_groups_match_plain_version(cuda, fn, T,
                                                             Hkv, G, D,
                                                             dtype):
    q, k, v, tables, starts, nb = _geometry_case(cuda, T, Hkv, G, D, dtype,
                                                 (70, 5, 300))
    got = fn(q, k, v, tables, starts, nb=nb)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,Bs,lens,window", [
    (pa.paged_decode_attention, 1, 4, 16, (300, 170, 517), 40),
    (pa.paged_decode_attention, 8, 4, 16, (300, 170, 517), 40),
    (pa.paged_attention, 9, 4, 16, (300, 170, 517), 40),
    (pa.paged_attention, 70, 4, 16, (300, 170, 517), 40),
    (pa.paged_decode_attention, 1, 4, 64, (4600, 10, 2000), 4096),
])
def test_kernels_over_rolled_tables_match_the_intact_ones(cuda, fn, T, G,
                                                          Bs, lens, window,
                                                          dtype):
    """The engine's rolling points the table entries of blocks wholly
    behind a row's window at trash block 0 (engine._roll_windows): over
    such a table, with the trash block full of 1e4, the kernels give the
    plain version's output over the intact table."""
    q, k, v, tables, starts, nb = _geometry_case(cuda, T, 2, G, 128, dtype,
                                                 lens, Bs=Bs)
    k[0] = 1.0e4
    v[0] = 1.0e4
    rolled = tables.clone()
    MB = tables.shape[1]
    for b, s in enumerate(starts.tolist()):
        rolled[b, :MB if s >= MB * Bs else max(s - window + 1, 0) // Bs] = 0
    assert (rolled[0] == 0).any()
    got = fn(q, k, v, rolled, starts, nb=nb, window=window)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb,
                                    window=window)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("exact", [True, False])
def test_moe_on_the_card_equals_the_cpu(cuda, exact):
    """ops/moe.moe_mlp in float32 on the card against the same call on
    the CPU (1e-5): the same expert ids, and in the dispatch (factor 0.5,
    padding masked) the same drop set."""
    from production_stack_tpu_torch.ops import moe
    g = torch.Generator().manual_seed(3)
    N, h, E, i = 96, 32, 4, 64
    x = torch.randn((N, h), generator=g)
    rw = torch.randn((h, E), generator=g) * 0.2
    gate, up = (torch.randn((E, h, i), generator=g) * 0.1 for _ in range(2))
    down = torch.randn((E, i, h), generator=g) * 0.1
    valid = torch.arange(N) < 80
    kw = dict(top_k=2, capacity_factor=0.5,
              dense_threshold=1000 if exact else 1)
    args = (x, rw, gate, up, down)
    want = moe.moe_mlp(*args, valid=valid, **kw)
    got = moe.moe_mlp(*(t.to(cuda) for t in args), valid=valid.to(cuda),
                      **kw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    ids_c = moe.route(x, rw, 2)[1]
    ids_g = moe.route(x.to(cuda), rw.to(cuda), 2)[1]
    assert torch.equal(ids_g.cpu(), ids_c)
    cap = moe.capacity_for(N, E, 2, 0.5)
    assert torch.equal(moe.dispatch_plan(ids_g, E, cap, valid.to(cuda)).cpu(),
                       moe.dispatch_plan(ids_c, E, cap, valid))


def _tier_runner(dev, kv_dtype):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.models import config as tconfig
    from production_stack_tpu_torch.models.kv import KVCache
    cfg = EngineConfig(model="debug-tiny", device=str(dev),
                       kv_dtype=kv_dtype, max_model_len=256,
                       max_num_seqs=3, kv_block_size=16)
    runner = ModelRunner(tconfig.get_config("debug-tiny"), cfg)
    g = torch.Generator().manual_seed(4)
    shape = runner.cache.k.shape
    if kv_dtype == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=g) * 0.05 + 1e-3
                  for _ in range(2))
        runner.cache = KVCache(k.to(dev), v.to(dev), ks.to(dev), vs.to(dev))
    else:
        runner.cache = KVCache(*(torch.randn(shape, generator=g).to(
            torch.bfloat16).to(dev) for _ in range(2)))
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (torch.randperm(3 * MB, generator=g) + 1).reshape(3, MB).to(
            torch.int32).numpy())
    return runner


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_tier_chunks_on_the_card_equal_the_cpu(cuda, kv_dtype):
    """runner.extract_chunk / inject_chunk on the card against the CPU on
    the same pool and tables: equal bf16 chunks out (an int8 pool
    dequantized in f32, then rounded), and after injecting a chunk equal
    pools (an int8 pool re-quantized: equal int8 payload and scales)."""
    c, d = _tier_runner("cpu", kv_dtype), _tier_runner(cuda, kv_dtype)
    for slot, start in ((1, 32), (2, 40), (0, 240)):
        kc, vc = c.extract_chunk(slot, start, 32)
        kd, vd = d.extract_chunk(slot, start, 32)
        assert kd.is_cuda and kd.is_contiguous()
        assert torch.equal(kd.cpu().view(torch.int16),
                           kc.view(torch.int16))
        assert torch.equal(vd.cpu().view(torch.int16),
                           vc.view(torch.int16))
    g = torch.Generator().manual_seed(5)
    chunk = [torch.randn(kc.shape, generator=g).to(torch.bfloat16)
             for _ in range(2)]
    c.inject_chunk(1, 64, *chunk)
    d.inject_chunk(1, 64, *(t.pin_memory() for t in chunk))
    for name in ("k", "v", "ks", "vs"):
        want, got = getattr(c.cache, name), getattr(d.cache, name)
        if want is not None:
            assert torch.equal(got.cpu(), want), name


def test_tier_round_trip_on_the_card_equals_the_cpu(cuda):
    """The connector on the card: a slot's prompt chunks published
    (gathered, copied into pinned memory behind an event, serialized by
    the writer thread) and fetched back (into pinned memory, copied to
    the card asynchronously) into another slot, whose blocks then hold
    the same chunks; the tier values equal the CPU run's byte for
    byte."""
    from types import SimpleNamespace

    from production_stack_tpu_torch.kvcache.connector import (
        KVConnector, KVTransferConfig)

    def run(dev):
        r = _tier_runner(dev, "bfloat16")
        conn = KVConnector(r, r.model_cfg, r.engine_cfg, KVTransferConfig(
            local_cpu_gb=0.01, chunk_size=32))
        prompt = list(range(100))
        seq = SimpleNamespace(prompt_tokens=prompt, output_tokens=[],
                              num_prefilled=100, slot=1,
                              kv_publish_state=None)
        conn.on_prefill_progress(seq)
        conn.flush()
        pf = conn.prefetch(prompt)
        assert pf is not None and pf.cached_tokens == 96
        assert all(k.is_pinned() == (r.device.type == "cuda")
                   for k, _ in pf.chunks)
        conn.inject(pf, 2)
        for i in range(3):
            for a, b in zip(r.extract_chunk(1, 32 * i, 32),
                            r.extract_chunk(2, 32 * i, 32)):
                assert torch.equal(a, b)
        values = [conn.store.get(k) for k in pf.keys]
        conn.close()
        return values
    assert run(cuda) == run("cpu")


@pytest.mark.parametrize("preset", ["minilm-l6", "bert-base"])
def test_encoder_on_the_card_equals_the_cpu(cuda, preset):
    """The BERT encoder at full width on the card (f32 weights from a
    seeded generator) against the same weights on the CPU: pooled
    vectors within 1e-4 of each vector's norm, over rows of 512, 100 and
    7 tokens in one batch; a row alone equals itself batched beside the
    512-token row within 1e-5."""
    from production_stack_tpu_torch.models import encoder as enc
    cfg = enc.get_encoder_config(preset)
    params = enc.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    cpu = enc.Encoder(cfg, device="cpu")
    cpu.load_state_dict(params.state_dict())
    g = torch.Generator().manual_seed(1)
    lens = torch.tensor([512, 100, 7])
    toks = torch.randint(0, cfg.vocab_size, (3, 512), generator=g)
    want = enc.encode(cpu, cfg, toks, lens)
    got = enc.encode(params, cfg, toks.to(cuda), lens.to(cuda)).cpu()
    err = ((got - want).abs().amax(dim=1) / want.norm(dim=1)).max()
    assert err <= 1e-4, err
    alone = enc.encode(params, cfg, toks[2:, :7].to(cuda),
                       lens[2:].to(cuda)).cpu()
    assert (alone[0] - got[2]).abs().max() <= 1e-5


def test_encoder_engine_on_the_card_equals_the_cpu(cuda):
    """embed_tokens of an engine with embedding_model on the card (the
    encoder on its own stream) against a CPU engine given the same
    encoder weights."""
    import numpy as np

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    kw = dict(model="debug-tiny", max_model_len=128, max_num_seqs=2,
              prefill_chunk=32, prefill_buckets=(16, 32),
              embedding_model="debug-encoder")
    gpu = LLMEngine(EngineConfig(device="cuda", **kw))
    cpu = LLMEngine(EngineConfig(device="cpu", **kw))
    cpu._enc_params.load_state_dict(gpu._enc_params.state_dict())
    lists = [[1, 2, 3], list(range(5, 105)), [7] * 40]
    a, b = gpu.embed_tokens(lists), cpu.embed_tokens(lists)
    assert a.shape == (3, 64) and np.isfinite(a).all()
    assert np.abs(a - b).max() <= 1e-4 * np.linalg.norm(b, axis=1).min()


def test_trace_middleware_on_a_card_engine(cuda):
    """A traced completion on a card engine: the inbound trace id on the
    reply, the parent span and the five phases in /debug/traces, and the
    paged kernels launched."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu_torch import tracing
    from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.server import build_app
    # TinyLlama's head dim 64: the kernels take D = 64, 128 and 256
    engine = AsyncLLMEngine(EngineConfig(
        model="tinyllama-1.1b", device="cuda", max_model_len=256,
        max_num_seqs=2, prefill_chunk=64, kv_block_size=64))
    tid, sid = tracing.new_trace_id(), tracing.new_span_id()

    async def body():
        async with TestClient(TestServer(build_app(engine,
                                                   api_key=""))) as c:
            r = await c.post("/v1/completions", json={
                "model": "tinyllama-1.1b", "prompt": "trace me on the card",
                "max_tokens": 6, "temperature": 0.0, "ignore_eos": True},
                headers={"traceparent": tracing.format_traceparent(
                    tid, sid)})
            assert r.status == 200 and r.headers["x-trace-id"] == tid
            r = await c.get("/debug/traces", params={"trace_id": tid})
            return (await r.json())["traces"]
    pa.reset_launch_counts()
    rows = asyncio.run(body())
    assert len(rows) == 1 and rows[0]["parent_id"] == sid
    assert [s["name"] for s in rows[0]["spans"] if s["kind"] == "phase"] \
        == ["preprocess", "queue_wait", "prefill", "decode", "postprocess"]
    assert rows[0]["attrs"]["output_tokens"] == 6
    assert all(pa.launch_counts[n] > 0 for n in pa.launch_counts)


# one tensor-parallel rank's heads (parallel/): Llama-3-8B at tp 2, 4 and
# 8 (Hkv 4, 2, 1 at G = 4, D = 128; at tp 8 the decode grid is
# (B, 1, splits)) and Gemma-2-9B at tp 2 (Hkv 4, G = 2, D = 256, window
# and softcap), decode and prefill, over a pool of q's dtype and over an
# int8 pool, through paged_attention_sharded
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Hkv,G,D,lens,window,softcap", [
    (1, 4, 4, 128, (70, 5, 300), 0, 0.0),
    (512, 4, 4, 128, (70, 5, 300), 0, 0.0),
    (1, 2, 4, 128, (4600, 10, 2000), 0, 0.0),
    (100, 2, 4, 128, (70, 5, 300), 0, 0.0),
    (1, 1, 4, 128, (4600, 10, 2000), 0, 0.0),
    (8, 1, 4, 128, (70, 5, 300), 0, 0.0),
    (512, 1, 4, 128, (70, 5, 300), 0, 0.0),
    (1, 4, 2, 256, (4600, 10, 2000), 4096, 50.0),
    (100, 4, 2, 256, (4550, 4100, 300), 4096, 50.0),
])
def test_kernels_at_one_tp_rank_match_plain_version(cuda, T, Hkv, G, D,
                                                    lens, window, softcap,
                                                    dtype, int8):
    from production_stack_tpu_torch.parallel.mesh import Shard
    q, k, v, tables, starts, nb = _geometry_case(
        cuda, T, Hkv, G, D, torch.float32, lens, seed=T + Hkv)
    sc = {}
    if int8:
        (k, ks), (v, vs) = quantize_chunk(k), quantize_chunk(v)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    if softcap:
        q = q * 30
        v = v if int8 else (v.float() * 0.5).to(dtype)
        if int8:
            sc["v_scales"] = sc["v_scales"] * 0.5
    q = q.to(dtype)
    tp = 8 // Hkv if D == 128 else 2
    shard = Shard(tp=tp, tp_rank=tp - 1)
    got = pa.paged_attention_sharded(
        q, k, v, tables, starts, shard, nb=nb, num_heads=Hkv * G * tp,
        num_kv_heads=Hkv * tp, window=window, softcap=softcap, **sc)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q.float() if int8 else q, k, v, tables,
                                    starts, nb, D ** -0.5, window, softcap,
                                    **sc)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_on_the_card_equals_one_rank(cuda, tp):
    """TinyLlama-1.1B (head dim 64, 4 kv heads) at tp = 2 and 4 in f32:
    with one card every rank shares it (gloo stages the collectives
    through the host), with a card per rank NCCL carries them; the
    kernels launch at one rank's heads, greedy tokens of mixed prompts
    equal the one-rank engine's on the same weights, and the workers
    sample rank 0's tokens."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    cfg = dict(model="tinyllama-1.1b", device="cuda", dtype="float32",
               kv_dtype="float32", max_model_len=256, max_num_seqs=3,
               prefill_chunk=64, prefill_buckets=(16, 64), decode_window=4,
               kv_block_size=16)
    prompts = [list(range(5, 45)), list(range(100, 107)),
               list(range(200, 300))]

    def run(engine):
        ids = [engine.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=12, ignore_eos=True))
            for p in prompts]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]
    want = run(LLMEngine(EngineConfig(**cfg)))
    te = LLMEngine(EngineConfig(tensor_parallel_size=tp, **cfg))
    try:
        assert te.runner.mesh.backend == (
            "nccl" if torch.cuda.device_count() >= tp else "gloo")
        pa.reset_launch_counts()
        assert run(te) == want
        assert pa.launch_counts["paged_attention"] > 0
        assert pa.launch_counts["paged_decode_attention"] > 0
        ranks = te.runner.last_results("decode")
        assert len(ranks) == tp
        assert all(torch.equal(r[0], ranks[0][0]) for r in ranks[1:])
    finally:
        te.close()


def _assembled_copy(k, v, ks, vs, tables, nb, dp=2):
    """The copy of every row's first nb blocks that dp ranks assemble
    (models/kv.assemble_blocks): each rank's gather_owned over its part
    of the pool (sharding.shard_cache, N padded to a multiple of dp),
    summed as ServingMesh.assemble sums them (int32 words of a float,
    int8 as it is). Returns (k, v, ks, vs) of B * nb blocks."""
    from production_stack_tpu_torch.models.kv import KVCache, gather_owned
    from production_stack_tpu_torch.parallel import sharding
    from production_stack_tpu_torch.parallel.mesh import Shard

    def pad(t):
        if t is None:
            return None
        n = sharding.padded_blocks(t.shape[0], dp)
        return torch.cat([t, torch.zeros_like(t[:n - t.shape[0]])])[None]
    full = KVCache(pad(k), pad(v), pad(ks), pad(vs))
    parts = [sharding.shard_cache(full, Shard(dp=dp, dp_rank=d))
             for d in range(dp)]

    def whole(name):
        if getattr(full, name) is None:
            return None
        got = [gather_owned(getattr(part, name)[0], part, tables, nb)
               for part in parts]
        bits = [g if g.element_size() == 1 else g.view(torch.int32)
                for g in got]
        return sum(bits[1:], bits[0]).view(got[0].dtype).flatten(0, 1)
    return tuple(whole(name) for name in ("k", "v", "ks", "vs"))


# dp > 1 serving: the kernels read a copy of each row's first nb blocks
# assembled from the dp ranks' parts of the pool, through
# pa.assembled_tables, at one tp rank's heads (Llama-3-8B at tp 2: Hkv 4,
# G 4, D 128); decode at T = 1 and 4 (a verify window of spec 3),
# prefill at T = 100 and 512, a long row beside short ones, a parked row
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,lens", [
    (1, (70, 5, 300)), (4, (70, 5, 300)), (4, (1000, 10, 400)),
    (100, (70, 5, 300)), (512, (70, 5, 300)),
])
def test_kernels_over_an_assembled_copy_match_plain_versions(cuda, T, lens,
                                                             dtype, int8):
    """The kernel over the assembled copy equals its plain version over
    the copy and over the pool itself within TOL, and the kernel over the
    pool bit for bit: the same values, nb and decode split plan."""
    q, k, v, tables, starts, nb = _geometry_case(
        cuda, T, 4, 4, 128, torch.float32, lens, seed=T + len(lens))
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = quantize_chunk(k), quantize_chunk(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    q = q.to(dtype)
    ck, cv, cks, cvs = _assembled_copy(k, v, ks, vs, tables, nb)
    B, MB = tables.shape
    ctables = pa.assembled_tables(B, nb, MB, cuda)
    assert ctables.shape == tables.shape and ck.shape[0] == B * nb
    fn = pa.paged_decode_attention if T <= pa.DECODE_T_MAX \
        else pa.paged_attention
    got = fn(q, ck, cv, ctables, starts, nb=nb, k_scales=cks, v_scales=cvs)
    pool = fn(q, k, v, tables, starts, nb=nb, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, pool)
    qp = q.float() if int8 else q
    for pk, pv, pt, pks, pvs in ((ck, cv, ctables, cks, cvs),
                                 (k, v, tables, ks, vs)):
        want = pa.paged_attention_plain(qp, pk, pv, pt, starts, nb,
                                        k_scales=pks, v_scales=pvs)
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()


def test_dp_engine_on_the_card_equals_tp(cuda):
    """TinyLlama-1.1B in f32 at dp = 2 x tp = 2 (behind
    dp_gather_attention_ok; every rank on the one card over gloo, or a
    card each over NCCL): greedy tokens of mixed prompts equal the tp = 2
    engine's on the same weights, both kernels launch on rank 0, and
    without the flag the mesh is refused."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.parallel.mesh import MeshConfig
    cfg = dict(model="tinyllama-1.1b", device="cuda", dtype="float32",
               kv_dtype="float32", max_model_len=256, max_num_seqs=3,
               prefill_chunk=64, prefill_buckets=(16, 64), decode_window=4,
               kv_block_size=16, tensor_parallel_size=2)
    prompts = [list(range(5, 45)), list(range(100, 107)),
               list(range(200, 300))]

    def run(engine):
        ids = [engine.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=12, ignore_eos=True))
            for p in prompts]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]
    mesh = MeshConfig(dp=2, tp=2)
    with pytest.raises(ValueError, match="gathered-view"):
        LLMEngine(EngineConfig(**cfg), mesh=mesh)
    tp = LLMEngine(EngineConfig(**cfg))
    try:
        want = run(tp)
    finally:
        tp.close()
    te = LLMEngine(EngineConfig(dp_gather_attention_ok=True, **cfg),
                   mesh=mesh)
    try:
        pa.reset_launch_counts()
        assert run(te) == want
        assert pa.launch_counts["paged_attention"] > 0
        assert pa.launch_counts["paged_decode_attention"] > 0
        assert te.runner.mesh.calls["dp.assemble"] > 0
    finally:
        te.close()


# ------------------------------------------------------------- training

def test_head_backward_on_the_card_matches_float_products(cuda):
    """The bf16 head's f32 logits (models/llama._HeadF32: torch.mm's
    out_dtype has no derivative) and its two backward products against
    the same products in float32 of the bf16 values, the logits'
    gradient rounded to bf16 as the backward rounds it."""
    from production_stack_tpu_torch.models.llama import _HeadF32
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 256, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    head = torch.randn(256, 512, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(64, 512, generator=g, device=cuda)
    y = _HeadF32.apply(x, head)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y.detach(), x.detach().float()
                               @ head.detach().float(), atol=1e-3,
                               rtol=1e-4)
    gx, gh = torch.autograd.grad(y, (x, head), dy)
    d16 = dy.to(torch.bfloat16).float()
    x, head = x.detach(), head.detach()
    for got, want in ((gx, d16 @ head.float().t()),
                      (gh, x.float().t() @ d16)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want).norm() / want.norm()) < 1e-2


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """Three train_steps of a small f32 model on the card and on the
    CPU from the same weights and tokens: the losses within 1e-4."""
    import numpy as np
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import ModelConfig
    from production_stack_tpu_torch.parallel import train
    cfg = ModelConfig(name="t", vocab_size=128, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=8,
                      num_kv_heads=4, max_position_embeddings=256,
                      dtype=torch.float32)
    base = llama.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (4, 32)))
    losses = {}
    for dev in ("cpu", cuda):
        model = llama.Llama(cfg, device=dev)
        with torch.no_grad():
            for p, q in zip(model.parameters(), base.parameters()):
                p.copy_(q)
        state = train.init_train_state(model)
        opt = train.make_optimizer()
        out = []
        for _ in range(3):
            state, loss = train.train_step(state, tokens.to(dev), cfg, opt)
            out.append(loss.item())
        losses[str(dev)] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4,
                               rtol=0)


def test_training_worlds_on_the_card(cuda):
    """parallel/dryrun.py on the card: dp 2 x sp 2 x tp 2 and pp = 2,
    every rank a process (gloo where ranks share a card, NCCL where each
    has its own); it raises on any miss."""
    from production_stack_tpu_torch.parallel import dryrun
    report = dryrun.dryrun_multichip(8, "cuda")
    assert report["max_loss_diff"] < dryrun.LOSS_TOL
    assert report["pp"]["loss_diff"] < dryrun.LOSS_TOL


# ------------------------------------------- int8 built a layer at a time

@pytest.mark.parametrize("preset", ["debug-tiny", "debug-moe"])
def test_int8_build_on_the_card_bit_equal_draw_then_quantize(cuda, preset):
    """llama.init_params(int8=True) on the card (each layer drawn,
    rounded to bf16 and quantized before the next) equals
    quantize_params of the whole bf16 draw from the same card
    generator, bit for bit, and at ep = 2 x tp = 2 each rank's slice
    equals shard_params of it."""
    import dataclasses
    from production_stack_tpu_torch.models import llama, quant
    from production_stack_tpu_torch.models.config import get_config
    from production_stack_tpu_torch.parallel import sharding
    from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard
    cfg = dataclasses.replace(get_config(preset), dtype=torch.bfloat16)

    def gen():
        return torch.Generator(device=cuda).manual_seed(4)
    whole = quant.quantize_params(llama.init_params(cfg, gen(), device=cuda))
    shards = [None]
    if cfg.num_experts:
        mesh = MeshConfig(ep=2, tp=2)
        shards += [Shard.of(mesh, r) for r in range(mesh.size)]
    for shard in shards:
        built = llama.init_params(cfg, gen(), device=cuda, shard=shard,
                                  int8=True)
        want = whole if shard is None else sharding.shard_params(whole,
                                                                 shard)
        a, b = built.state_dict(), want.state_dict()
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].device.type == cuda.type, name
            assert torch.equal(a[name], b[name]), name


def test_int8_moe_engine_on_the_card_equals_the_cpu(cuda, tmp_path):
    """debug-moe at head dim 64 (the kernels' smallest; the dry run's
    config.json) with int8 weights in f32, capacity factor 0.5: the CPU
    engine builds its
    weights a layer at a time, the card engine is given them; greedy
    tokens of mixed prompts (the prefill's capacity dispatch and the
    decode's exact path over the int8 expert stacks, both paged kernels
    launched) equal the CPU's."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.models import quant
    from production_stack_tpu_torch.parallel import dryrun
    model = dryrun.tiny_model("debug-moe", cuda, str(tmp_path))
    cfg = dict(model, dtype="float32", kv_dtype="float32",
               quantization="int8", moe_capacity_factor=0.5,
               max_model_len=256, max_num_seqs=3,
               prefill_chunk=64, prefill_buckets=(16, 64), decode_window=4,
               kv_block_size=16)
    prompts = [list(range(5, 45)), list(range(100, 107)),
               list(range(200, 300))]

    def run(engine):
        ids = [engine.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=12, ignore_eos=True))
            for p in prompts]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]
    cpu = LLMEngine(EngineConfig(device="cpu", **cfg))
    assert quant.is_quantized(cpu.runner.params.gate)
    want = run(cpu)
    card = LLMEngine(EngineConfig(device=str(cuda), **cfg),
                     params=cpu.runner.params.to(cuda))
    pa.reset_launch_counts()
    assert run(card) == want
    assert pa.launch_counts["paged_attention"] > 0
    assert pa.launch_counts["paged_decode_attention"] > 0
