"""Parity of the PyTorch port's ops with the JAX package's on the CPU:
norms, rope, the paged KV pool, the plain cache attention with a sliding
window and a softcap, and the plain versions of the three attention
kernels (paged decode, paged prefill, flash over a contiguous cache)
against the Pallas kernels in interpret mode.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
Tolerances (float32 throughout):
- elementwise ops and the pool: exact, or 1e-6 where the two libraries
  may fuse or reorder float32 arithmetic differently;
- cache attention and the kernels: 2e-5, the bound
  tests/test_pallas_paged.py holds the Pallas kernels to against the
  dense jnp path (softmax sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.models import kv as jkv
from production_stack_tpu.ops import attention as jattention
from production_stack_tpu.ops import norms as jnorms
from production_stack_tpu.ops import rope as jrope
from production_stack_tpu.ops.pallas_attention import (
    flash_attention_with_cache as pallas_flash_attention)
from production_stack_tpu.ops.pallas_paged import (
    paged_attention as pallas_paged_attention,
    paged_decode_attention as pallas_paged_decode_attention)
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.ops import attention as tattention
from production_stack_tpu_torch.ops import flash_attention as tfa
from production_stack_tpu_torch.ops import norms as tnorms
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.ops import rope as trope


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                      1e-5, offset=offset))
    got = tnorms.rms_norm(_t(x), _t(w), 1e-5, offset=offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scaling", [
    None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 8192.0)])
def test_rope_table_and_apply_match_jax(scaling):
    P, D = 96, 32
    jc, js = jrope.rope_table(P, D, 5e5, scaling=scaling)
    tc, ts = trope.rope_table(P, D, 5e5, scaling=scaling)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, P, size=(2, 7)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       jc, js))
    got = trope.apply_rope(_t(x), _t(pos), _t(tc), _t(ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_apply_rope_clamps_positions_past_the_table():
    """Parked rows sit at max_model_len and advance past it inside a
    decode window: JAX's gather clamps such positions into the table,
    and the port must clamp the same way (on CUDA an index out of range
    is a device-side assert)."""
    P, D = 16, 8
    c, s = trope.rope_table(P, D)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 2, D)).astype(np.float32)
    pos = np.array([[P - 1, P, P + 3, 10 * P]], np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       c, s))
    got = trope.apply_rope(_t(x), _t(pos), _t(c), _t(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # every clamped row rotates exactly like the last table position
    for t in range(1, 4):
        clamp = trope.apply_rope(_t(x[:, t:t + 1]),
                                 _t(np.array([[P - 1]], np.int32)),
                                 _t(c), _t(s)).numpy()
        np.testing.assert_array_equal(got[:, t:t + 1], clamp)


def _shuffled_tables(rng, B, MB, N):
    perm = rng.permutation(N - 1)[:B * MB] + 1
    return perm.reshape(B, MB).astype(np.int32)


def test_write_chunk_and_gather_view_match_jax():
    """The same writes land bit for bit in both pools outside trash
    block 0 (which takes invalid, negative and past-capacity tokens in
    a collision order neither side promises)."""
    rng = np.random.default_rng(3)
    N, Hkv, Bs, D, B, T, MB = 24, 2, 8, 16, 3, 10, 4
    pool = rng.standard_normal((N, Hkv, Bs, D)).astype(np.float32)
    tables = _shuffled_tables(rng, B, MB, N)
    new = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    positions = np.stack([np.arange(T) + s for s in (0, 13, MB * Bs - 4)]
                         ).astype(np.int32)
    positions[0, 2] = -3                      # negative -> trash
    valid = np.ones((B, T), bool)
    valid[1, 5:] = False                      # padding -> trash
    want = np.asarray(jkv.write_chunk(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(tables),
                                      jnp.asarray(positions),
                                      valid=jnp.asarray(valid)))
    got = tkv.write_chunk(_t(pool), _t(new), _t(tables), _t(positions),
                          valid=_t(valid)).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])
    nb = 3
    np.testing.assert_array_equal(
        tkv.gather_view(_t(want), _t(tables), nb).numpy(),
        np.asarray(jkv.gather_view(jnp.asarray(want), jnp.asarray(tables),
                                   nb)))


def test_linear_tables_and_slot_cache_match_jax():
    np.testing.assert_array_equal(
        tkv.linear_tables(3, 50, 16, device="cpu").numpy(),
        np.asarray(jkv.linear_tables(3, 50, 16)))
    tc, tt = tkv.make_slot_cache(2, 3, 50, 2, 16, dtype=torch.float32,
                                 device="cpu")
    jc, jt = jkv.make_slot_cache(2, 3, 50, 2, 16, dtype=jnp.float32)
    assert tuple(tc.k.shape) == jc.k.shape
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _assert_matches_pallas(got, want, starts, tables, Bs):
    """Live rows agree with the Pallas kernel; a parked row (start >=
    MB*Bs, output discarded by the engine) is finite on both sides and
    zeros in the port, which does no work for it."""
    live = starts < tables.shape[1] * Bs
    np.testing.assert_allclose(got[live], want[live], rtol=2e-5, atol=2e-5)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert (got[~live] == 0).all()


def _paged_case(seed, T, G, D, Bs, lens, parked=False):
    """A one-layer pool with shuffled tables, ragged row lengths, the
    chunk's own K/V written first (write-then-attend), and optionally a
    last row parked past the virtual capacity MB*Bs."""
    rng = np.random.default_rng(seed)
    B, Hkv = len(lens), 2
    H = Hkv * G
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 4
    k = rng.standard_normal((N, Hkv, Bs, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, Bs, D)).astype(np.float32)
    tables = _shuffled_tables(rng, B, MB, N)
    starts = np.array(lens, np.int32)
    if parked:
        starts[-1] = MB * Bs + 5
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    positions = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    newk = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    newv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    k = np.asarray(jkv.write_chunk(jnp.asarray(k), jnp.asarray(newk),
                                   jnp.asarray(tables),
                                   jnp.asarray(positions)))
    v = np.asarray(jkv.write_chunk(jnp.asarray(v), jnp.asarray(newv),
                                   jnp.asarray(tables),
                                   jnp.asarray(positions)))
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return q, k, v, tables, starts, nb


@pytest.mark.parametrize("T,G,D,Bs,parked", [
    (1, 4, 32, 16, False),     # decode step, GQA
    (5, 2, 32, 16, True),      # speculative-size window, a parked row
    (8, 4, 64, 16, False),     # DECODE_T_MAX
])
def test_plain_decode_matches_pallas_decode_kernel(T, G, D, Bs, parked):
    q, k, v, tables, starts, nb = _paged_case(T * 7 + G, T, G, D, Bs,
                                              [37, 5, 50], parked)
    want = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(starts), nb=nb, interpret=True))
    before = dict(tpa.launch_counts)
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                     _t(starts), nb=nb).numpy()
    _assert_matches_pallas(got, want, starts, tables, Bs)
    # the plain CPU path launches nothing
    assert tpa.launch_counts == before


@pytest.mark.parametrize("T,G,D,Bs,parked", [
    (9, 2, 32, 16, False),     # shortest prefill chunk
    (40, 4, 32, 16, True),     # ragged block boundary, a parked row
])
def test_plain_prefill_matches_pallas_paged_kernel(T, G, D, Bs, parked):
    q, k, v, tables, starts, nb = _paged_case(T * 3 + G, T, G, D, Bs,
                                              [10, 33, 21], parked)
    want = np.asarray(pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(starts), nb=nb, interpret=True))
    got = tpa.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                              nb=nb).numpy()
    _assert_matches_pallas(got, want, starts, tables, Bs)


@pytest.mark.parametrize("window,softcap", [
    (None, None), (24, None), (None, 5.0), (24, 5.0)])
def test_attention_with_cache_window_softcap_matches_jax(window, softcap):
    """The plain cache attention with Gemma-2's sliding window and
    softcap against the JAX function; q scaled so that the raw scores
    reach the cap."""
    rng = np.random.default_rng(7)
    B, T, Hkv, G, D, S = 2, 6, 2, 2, 16, 64
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32) * 3
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = (np.array([[40], [57]]) + np.arange(T)).astype(np.int32)
    want = np.asarray(jattention.attention_with_cache(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale=0.31, sliding_window=window, logit_softcap=softcap))
    got = tattention.attention_with_cache(
        _t(q), _t(k), _t(v), _t(pos), scale=0.31, sliding_window=window,
        logit_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# window 40 is not a multiple of Bs = 16, and rows 0 and 2 sit well past
# it, so the Pallas kernels skip blocks before the window; q is scaled
# by 0.31 with a softcap of 5 as in tests/test_gemma2.py, where the raw
# scores reach the cap
@pytest.mark.parametrize("fn,T,G,D,window,softcap,parked", [
    ("decode", 1, 2, 32, 40, 0.0, False),
    ("decode", 5, 2, 32, 40, 5.0, True),
    ("decode", 8, 4, 64, 0, 5.0, False),
    ("prefill", 40, 2, 32, 40, 0.0, True),
    ("prefill", 24, 2, 32, 40, 5.0, False),
])
def test_plain_window_softcap_matches_pallas_kernels(fn, T, G, D, window,
                                                     softcap, parked):
    q, k, v, tables, starts, nb = _paged_case(T * 11 + window, T, G, D, 16,
                                              [90, 5, 130], parked)
    pallas = (pallas_paged_decode_attention if fn == "decode"
              else pallas_paged_attention)
    port = (tpa.paged_decode_attention if fn == "decode"
            else tpa.paged_attention)
    want = np.asarray(pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(starts), nb=nb, interpret=True, window=window,
        scale=0.31, softcap=softcap))
    got = port(_t(q), _t(k), _t(v), _t(tables), _t(starts), nb=nb,
               scale=0.31, window=window, softcap=softcap).numpy()
    _assert_matches_pallas(got, want, starts, tables, 16)
    # the window changes the answer: the rows past it see fewer keys
    if window:
        full = port(_t(q), _t(k), _t(v), _t(tables), _t(starts), nb=nb,
                    scale=0.31, softcap=softcap).numpy()
        assert np.abs(full[0] - got[0]).max() > 1e-3


# T and S are not multiples of the port's tiles (positions per tile,
# 64-key panels) nor of the Pallas blocks (block_q 8, block_k 32 halved
# to 16 for S = 48)
@pytest.mark.parametrize("T,S,G,D,starts", [
    (20, 48, 2, 32, [0, 10, 28]),
    (1, 100, 4, 32, [99, 37, 0]),
    (13, 100, 1, 64, [87, 50, 3]),
    # G = 3 does not divide the bf16 kernel's 128-row tile
    (10, 48, 3, 32, [0, 20, 38]),
])
def test_plain_flash_matches_pallas_flash_kernel(T, S, G, D, starts):
    rng = np.random.default_rng(T + S)
    B, Hkv = len(starts), 2
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    st = np.array(starts, np.int32)
    want = np.asarray(pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
        block_q=8, block_k=32, interpret=True))
    before = dict(tfa.launch_counts)
    got = tfa.flash_attention_with_cache(_t(q), _t(k), _t(v),
                                         _t(st)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert tfa.launch_counts == before


@pytest.mark.parametrize("flag", [
    dict(k_scales=torch.ones(1), v_scales=torch.ones(1))])
@pytest.mark.parametrize("fn", [tpa.paged_attention,
                                tpa.paged_decode_attention])
def test_kernel_flags_off_this_path_raise(fn, flag):
    """int8 scales go with an int8 pool only (tests/test_torch_quant.py
    runs the int8 pool): over a float pool the wrappers refuse them, on
    the CPU as on the card."""
    q, k, v, tables, starts, nb = _paged_case(0, 1, 2, 32, 16, [5])
    with pytest.raises(ValueError, match="int8 pool"):
        fn(_t(q), _t(k), _t(v), _t(tables), _t(starts), nb=nb, **flag)


# ------------------------------------------------ decode split and merge

@pytest.mark.parametrize("nb", range(1, 131))
def test_decode_split_plan_covers_every_block_once(nb):
    """The decode kernel's plan: at most MAX_SPLITS splits of bps blocks,
    together covering blocks 0..nb-1, each block in exactly one split and
    no split empty of blocks."""
    bps, splits = tpa.decode_split_plan(nb)
    assert 1 <= splits <= tpa.MAX_SPLITS and bps >= 1
    covered = [j for s in range(splits)
               for j in range(s * bps, min((s + 1) * bps, nb))]
    assert covered == list(range(nb))
    assert (splits - 1) * bps < nb


def _split_merge_plain(q, k_pool, v_pool, tables, starts, nb, scale, window,
                       softcap, bps):
    """The decode kernel's arithmetic in plain PyTorch (float32): each
    split of bps blocks attends its key range of the gathered view and
    keeps a partial (m, l, acc) — a split wholly past its row's last block
    or wholly before its window, and every split of a parked row, keeps
    the empty partial (m = -1e30, l = 0, acc = 0); then the merge weighs
    each split by exp(m_s - m) (0 for a split carrying the sentinel) and
    divides by the merged l."""
    B, T, H, D = q.shape
    Hkv, Bs = k_pool.shape[1], k_pool.shape[2]
    G, MB = H // Hkv, tables.shape[1]
    k_att = tkv.gather_view(k_pool, tables, nb).float()   # [B, S, Hkv, D]
    v_att = tkv.gather_view(v_pool, tables, nb).float()
    splits = -(-nb // bps)
    neg = -1e30
    out = torch.zeros(B, T, H, D)
    for b in range(B):
        start = int(starts[b])
        jend = min((start + T - 1) // Bs, nb - 1)
        jmin = max(start - (window - 1), 0) // Bs if window else 0
        qb = q[b].float().reshape(T, Hkv, G, D) * scale
        qpos = start + torch.arange(T)
        ms, ls, accs = [], [], []
        for s in range(splits):
            jlo, jhi = max(s * bps, jmin), min((s + 1) * bps - 1, jend)
            if start >= MB * Bs or jlo > jhi:
                ms.append(torch.full((Hkv, G, T), neg))
                ls.append(torch.zeros(Hkv, G, T))
                accs.append(torch.zeros(Hkv, G, T, D))
                continue
            kpos = torch.arange(jlo * Bs, (jhi + 1) * Bs)
            sc = torch.einsum("tkgd,skd->kgts", qb, k_att[b, kpos])
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            live = kpos[None, :] <= qpos[:, None]
            if window:
                live = live & (kpos[None, :] > qpos[:, None] - window)
            sc = torch.where(live, sc, torch.full((), neg))
            m = sc.amax(-1)
            p = torch.where(live, torch.exp(sc - m[..., None]),
                            torch.zeros(()))
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("kgts,skd->kgtd", p, v_att[b, kpos]))
        m_s, l_s, acc_s = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        M = m_s.amax(0)
        w = torch.where(m_s == neg, torch.zeros(()), torch.exp(m_s - M))
        L = (w * l_s).sum(0)
        o = (w[..., None] * acc_s).sum(0) / L.clamp_min(1e-30)[..., None]
        out[b] = o.permute(2, 0, 1, 3).reshape(T, H, D)
    return out


# T = 8; a window of 40 over blocks of 16 that begins mid-split (bps 2:
# the row at 130 sees blocks 5..8, its window from position 91) with
# the splits before it wholly before the window; rows of 1 block (5) whose
# later splits lie wholly past their end; a parked row
@pytest.mark.parametrize("T,G,D,window,softcap,bps,parked", [
    (8, 4, 32, 0, 0.0, 1, False),
    (8, 2, 32, 40, 5.0, 2, True),
    (1, 2, 32, 40, 0.0, 3, True),
    (5, 4, 64, 24, 5.0, 2, False),
])
def test_split_merge_equals_unsplit_plain_and_pallas_decode(
        T, G, D, window, softcap, bps, parked):
    q, k, v, tables, starts, nb = _paged_case(T * 13 + bps, T, G, D, 16,
                                              [90, 5, 130], parked)
    scale = 0.31
    want = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(starts), nb=nb, interpret=True, window=window,
        scale=scale, softcap=softcap))
    plain = tpa.paged_attention_plain(_t(q), _t(k), _t(v), _t(tables),
                                      _t(starts), nb, scale, window,
                                      softcap).numpy()
    got = _split_merge_plain(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                             nb, scale, window, softcap, bps).numpy()
    assert -(-nb // bps) > 2   # several splits
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)
    _assert_matches_pallas(got, want, starts, tables, 16)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_tile_geometry_fits_and_covers_every_row(D, int8):
    """The bfloat16-q decode kernel's plan for every R = T*G up to 8 x 16
    and every ring depth: row groups of at most 64 rows cover R, m16
    tiles cover a group, the tile's warps split its keys in 16-key chunks
    (4 warps over one tile, 2 over each of two, 1 over each of three or
    four); its shared memory fits a block; up to 16 rows (G <= 4 at T =
    4) two blocks fit an SM's 228 KB (1 KB reserved a block), and three
    with a one-stage ring at D <= 128."""
    for bps, stages in ((1, 1), (2, 2), (4, 3)):
        for R in range(1, 129):
            tile = tpa.decode_tile(D, R, int8, bps, 32 if D == 256 else 64)
            assert tile["stages"] == stages
            group = min(R, 64)
            assert tile["row_groups"] * 64 >= R \
                > (tile["row_groups"] - 1) * 64
            assert tile["m_tiles"] * 16 >= group > (tile["m_tiles"] - 1) * 16
            assert tile["warps_per_tile"] * min(tile["m_tiles"], 4) <= 4
            assert tile["keys"] % (16 * tile["warps_per_tile"]) == 0 \
                or tile["warps_per_tile"] == 4
            assert tile["smem_bytes"] <= 232448
            blocks = 3 if stages == 1 and D <= 128 else 2
            if R <= 16:
                assert blocks * (tile["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("nb,Bs,D,want", [
    (8, 64, 128, 1),     # a 512-token bucket: one 64-key block a split
    (8, 64, 256, 2),     # the same at Gemma-2's 32-key panels
    (128, 64, 256, 3),   # an 8192-token bucket: 4 blocks a split
    (72, 16, 128, 1),    # 3 blocks of 16 keys: 48 keys, one panel
    (200, 16, 128, 2),   # 7 blocks of 16: 112 keys, two panels
])
def test_decode_ring_holds_no_more_stages_than_a_split_has_panels(
        nb, Bs, D, want):
    bps, _ = tpa.decode_split_plan(nb)
    assert tpa.decode_tile(D, 4, bps=bps, Bs=Bs)["stages"] == want


def _mma_decode_plain(q, k_pool, v_pool, tables, starts, nb, scale, window,
                      softcap):
    """The bfloat16-q decode kernel's decomposition in plain PyTorch
    (float32): per split (decode_split_plan), the split's keys in panels of decode_tile's `keys`, each panel's
    16-key chunks dealt to the tile's warps in turn ((panel * chunks +
    chunk) % warps_per_tile), every warp an online softmax over its
    chunks (a masked key p = 0); the warps combined by exp(m_w - m), the
    splits merged by exp(m_s - m); a group with nothing to attend gives
    the empty partial."""
    B, T, H, D = q.shape
    Hkv, Bs = k_pool.shape[1], k_pool.shape[2]
    G, MB = H // Hkv, tables.shape[1]
    k_att = tkv.gather_view(k_pool, tables, nb).float()
    v_att = tkv.gather_view(v_pool, tables, nb).float()
    bps, splits = tpa.decode_split_plan(nb)
    R = T * G
    tile = tpa.decode_tile(D, R)
    keys, kw = tile["keys"], tile["warps_per_tile"]
    neg = -1e30
    out = torch.zeros(B, Hkv, R, D)
    for b in range(B):
        start = int(starts[b])
        jend = min((start + T - 1) // Bs, nb - 1)
        jmin = max(start - (window - 1), 0) // Bs if window else 0
        # rows r = t * G + g of kv head h
        qb = q[b].float().reshape(T, Hkv, G, D).permute(1, 0, 2, 3) \
            .reshape(Hkv, R, D)
        qpos = start + torch.arange(R) // G
        parts = []
        for s in range(splits):
            jlo, jhi = max(s * bps, jmin), min((s + 1) * bps - 1, jend)
            if start >= MB * Bs or jlo > jhi:
                parts.append((torch.full((Hkv, R), neg),
                              torch.zeros(Hkv, R), torch.zeros(Hkv, R, D)))
                continue
            k_lo, k_hi = jlo * Bs, (jhi + 1) * Bs
            warps = [[torch.full((Hkv, R), neg), torch.zeros(Hkv, R),
                      torch.zeros(Hkv, R, D)] for _ in range(kw)]
            for i in range(-(-(k_hi - k_lo) // keys)):
                for c in range(keys // 16):
                    w = warps[(i * (keys // 16) + c) % kw]
                    kpos = k_lo + i * keys + c * 16 + torch.arange(16)
                    inside = kpos < k_hi
                    kk = kpos.clamp(max=k_att.shape[1] - 1)
                    sc = torch.einsum("krd,skd->krs", qb,
                                      k_att[b, kk]) * scale
                    if softcap:
                        sc = softcap * torch.tanh(sc / softcap)
                    live = (inside & (kpos < nb * Bs))[None, :] \
                        & (kpos[None, :] <= qpos[:, None])
                    if window:
                        live = live & (kpos[None, :] > qpos[:, None] - window)
                    sc = torch.where(live, sc, torch.full((), neg))
                    m_new = torch.maximum(w[0], sc.amax(-1))
                    corr = torch.exp(w[0] - m_new)
                    p = torch.where(live, torch.exp(sc - m_new[..., None]),
                                    torch.zeros(()))
                    vv = torch.where(inside[:, None, None], v_att[b, kk],
                                     torch.zeros(()))
                    w[2] = w[2] * corr[..., None] + torch.einsum(
                        "krs,skd->krd", p, vv)
                    w[1] = w[1] * corr + p.sum(-1)
                    w[0] = m_new
            m_w = torch.stack([w[0] for w in warps])
            mx = m_w.amax(0)
            wt = torch.where(m_w == neg, torch.zeros(()), torch.exp(m_w - mx))
            parts.append((mx, (wt * torch.stack([w[1] for w in warps])).sum(0),
                          (wt[..., None] * torch.stack([w[2] for w in warps])
                           ).sum(0)))
        m_s = torch.stack([p[0] for p in parts])
        M = m_s.amax(0)
        wt = torch.where(m_s == neg, torch.zeros(()), torch.exp(m_s - M))
        L = (wt * torch.stack([p[1] for p in parts])).sum(0)
        out[b] = (wt[..., None] * torch.stack([p[2] for p in parts])
                  ).sum(0) / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, T, H, D)


# T * G of 4 (one tile, 4 warps), 20 (two tiles, 2 warps each) and 56
# (four tiles, a warp each) at D = 64 and 256 (panels of 64 and 32
# keys); 17 splits of a 33-block row over blocks of 16 with a window
# starting mid-split; a parked row
@pytest.mark.parametrize("T,G,D,window,softcap", [
    (1, 4, 64, 0, 0.0),
    (5, 4, 256, 40, 5.0),
    (8, 7, 64, 24, 0.0),
])
def test_mma_decode_decomposition_equals_unsplit_plain(T, G, D, window,
                                                       softcap):
    q, k, v, tables, starts, nb = _paged_case(T * 7 + G, T, G, D, 16,
                                              [520, 5, 130], True)
    scale = 0.31
    plain = tpa.paged_attention_plain(_t(q), _t(k), _t(v), _t(tables),
                                      _t(starts), nb, scale, window,
                                      softcap).numpy()
    got = _mma_decode_plain(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                            nb, scale, window, softcap).numpy()
    assert tpa.decode_split_plan(nb)[1] > 16   # many splits
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_prefill_tile_geometry_fits_a_block(D):
    """The bfloat16 prefill tile: 64 query rows (one wgmma M), 64-key
    panels, a ring of at least two K/V stages, and Q plus the ring within
    the 232,448 bytes of shared memory a block may use."""
    tile = tpa.prefill_tile(D)
    assert tile["rows"] == 64 and tile["keys"] == 64
    assert tile["stages"] >= 2
    panel = 64 * D * 2                          # [64, D] bf16
    assert tile["smem_bytes"] >= panel * (1 + 2 * tile["stages"])
    assert tile["smem_bytes"] <= 232448
    # G query heads of one kv head fill the tile's rows
    for G in (1, 2, 4, 8):
        assert (tile["rows"] // G) * G == tile["rows"]


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_tile_geometry_fits_a_block(D):
    """The bfloat16 flash tile: rows a multiple of 64 (one wgmma M per
    consumer warpgroup), panels of 64 or 128 keys (a wgmma N), a ring of
    at least two K/V stages, and Q plus the ring within the 232,448 bytes
    of shared memory a block may use."""
    tile = tfa.flash_tile(D)
    assert tile["rows"] % 64 == 0 and tile["rows"] == 64 * tile["consumers"]
    assert tile["keys"] in (64, 128) and tile["stages"] >= 2
    q, panel = 64 * D * 2, tile["keys"] * D * 2     # bf16
    assert tile["smem_bytes"] >= (q * tile["consumers"]
                                  + panel * 2 * tile["stages"])
    assert tile["smem_bytes"] <= 232448


def test_flash_profile_timer_sites_are_in_the_kernel():
    """tools/flash_profile.py attaches its timers to statements of
    csrc/flash_attention.cu: each must be there exactly once."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "flash_profile", os.path.join(root, "tools", "flash_profile.py"))
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    with open(os.path.join(root, "production_stack_tpu_torch", "csrc",
                           "flash_attention.cu")) as f:
        src = f.read()
    for site, _ in profile.PATCHES:
        assert src.count(site) == 1, site[:60]
