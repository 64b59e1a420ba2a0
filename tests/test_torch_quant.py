"""Parity of the PyTorch port's int8 serving with the JAX package's on
the CPU: weight-only int8 (models/quant.py), the int8 KV pool
(models/kv.py), the paged kernels' plain versions over an int8 pool
against the Pallas kernels' int8 branches in interpret mode, the forward
with int8 weights and pool, the engine and the server's flags.

Inputs are drawn with numpy from fixed seeds (or by the JAX package, then
carried across) and handed to both sides. Tolerances:
- quantization of weights, embeddings and K/V chunks: bit-equal (both
  round half to even on the same float32 values);
- pools, scales and gathered views: equal outside trash block 0;
- paged attention over an int8 pool, float32: 2e-5, the bound
  tests/test_kv_int8.py holds the Pallas kernels to (the softmax sums in
  another order); bfloat16 q: 3e-2 (bf16 outputs, and the plain version
  rounds the dequantized K/V and the probabilities to bf16 where the
  Pallas kernel keeps them in float32);
- float32 logits through int8 weights and an int8 pool: 1e-4, as the
  full-precision forward of tests/test_torch_model.py, until the two
  sides round a K/V value at a tie differently (see the test), then
  1e-3;
- engines: greedy tokens exactly.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import quant as jquant
from production_stack_tpu.ops.pallas_paged import (
    paged_attention as pallas_paged_attention,
    paged_decode_attention as pallas_paged_decode_attention)
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app, parse_args
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import quant as tquant
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.weights import cache_from_jax, params_from_jax

from tests.torch_geometry import FIXED

_BF16 = jnp.bfloat16


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_and_embed_bit_equal_jax(dtype):
    """A layer stack [L, in, out] per output channel and an embedding
    [V, H] per row: the same int8 values and float32 scales, bit for
    bit, from f32 or bf16 weights (one column of zeros takes the 1e-8
    floor)."""
    rng = np.random.default_rng(0)
    stack = (rng.standard_normal((3, 40, 24)) * 0.05).astype(np.float32)
    stack[1, :, 5] = 0.0
    emb = (rng.standard_normal((50, 32)) * 0.02).astype(np.float32)
    if dtype == "bfloat16":
        stack = np.asarray(jnp.asarray(stack, _BF16).astype(jnp.float32))
        emb = np.asarray(jnp.asarray(emb, _BF16).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    for jfn, tfn, w in ((jquant.quantize_tensor, tquant.quantize_tensor,
                         stack),
                        (jquant.quantize_embed, tquant.quantize_embed, emb)):
        want = jfn(jnp.asarray(w, getattr(jnp, dtype)))
        got = tfn(_t(w).to(tdt))
        assert got.w8.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.w8.numpy(), _np(want["w8"]))
        np.testing.assert_array_equal(got.scale.numpy(), _np(want["scale"]))


def test_dequant_matmul_and_rows_match_jax():
    """(x @ w8) * scale and the embedding gather, f32, equal to JAX's
    within float32 summation order."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((2, 48, 16)) * 0.05).astype(np.float32)
    emb = (rng.standard_normal((30, 48)) * 0.02).astype(np.float32)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    rows = rng.integers(0, 30, (3, 5)).astype(np.int32)
    jw, je = jquant.quantize_tensor(jnp.asarray(w)), \
        jquant.quantize_embed(jnp.asarray(emb))
    tw, te = tquant.quantize_tensor(_t(w)), tquant.quantize_embed(_t(emb))
    want = _np(jquant.dequant_matmul(jnp.asarray(x), {"w8": jw["w8"][1],
                                                      "scale": jw["scale"][1]}))
    got = tquant.dequant_matmul(_t(x), tquant.Int8Weight(tw.w8[1],
                                                         tw.scale[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tquant.dequant_rows(te, _t(rows).long(), torch.float32).numpy(),
        _np(jquant.dequant_rows(je, jnp.asarray(rows), jnp.float32)))


def _jax_params(model, dtype, seed, tie=None):
    kw = {} if tie is None else dict(tie_word_embeddings=tie)
    jcfg = dataclasses.replace(jconfig.get_config(model),
                               dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(tconfig.get_config(model),
                               dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg, jllama.init_params(jcfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("model,tie", [("debug-tiny", False),
                                       ("debug-tiny", True),
                                       ("debug-gemma2", None),
                                       ("debug-moe", None)])
def test_quantize_params_of_carried_weights_bit_equal_jax(model, tie):
    """bf16 weights drawn by JAX and carried across: the port's
    quantize_params gives JAX's quantize_params leaves bit for bit (the
    MoE's expert stacks too), norms and the router untouched; the
    JAX-quantized leaves carried across by params_from_jax give the same
    module."""
    _, tcfg, params = _jax_params(model, "bfloat16", 3, tie)
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(params))
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    ours = tquant.quantize_params(carried)
    theirs = params_from_jax(jq, tcfg, device="cpu")
    names = ["embed"] + [n for n in tllama.LAYER_KEYS
                         if n not in tquant._SKIP_LAYER and
                         hasattr(ours, n)]
    if not tcfg.tie_word_embeddings:
        names.append("lm_head")
    for name in names:
        src = jq["layers"][name] if name in tllama.LAYER_KEYS else jq[name]
        for m in (ours, theirs):
            w = getattr(m, name)
            assert tquant.is_quantized(w), name
            np.testing.assert_array_equal(w.w8.numpy(), src["w8"])
            np.testing.assert_array_equal(w.scale.numpy(), src["scale"])
    norms = [n for n, _ in ours.named_parameters()]
    # a MoE model's router stays in the model dtype too (JAX _SKIP_LAYER)
    assert ("router" in norms) == bool(tcfg.num_experts)
    assert norms and all(n in tllama.NORM_KEYS for n in norms
                         if n != "router")


# --------------------------------------------------------------- int8 pool

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_chunk_bit_equal_jax(dtype):
    rng = np.random.default_rng(2)
    new = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    new[0, 1, 2] = 0.0   # a zero vector takes the 1e-8 floor
    jq, js = jkv.quantize_chunk(jnp.asarray(new, getattr(jnp, dtype)))
    tq, ts = tkv.quantize_chunk(
        _t(np.asarray(jnp.asarray(new, getattr(jnp, dtype)), np.float32))
        .to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_write_chunk_q_and_gather_view_q_match_jax():
    """make_cache(int8) pools, write_chunk_q through shuffled tables with
    padding and out-of-range positions (to the trash block), then
    gather_view_q in f32 and bf16: equal to JAX's outside block 0."""
    L, N, Hkv, Bs, D = 1, 12, 2, 8, 16
    rng = np.random.default_rng(3)
    tables = (rng.permutation(N - 1)[:6] + 1).reshape(2, 3).astype(np.int32)
    positions = np.array([[3, 4, 5, 6, 7, 8], [10, 11, 12, 13, 30, 40]],
                         np.int32)
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    new = rng.standard_normal((2, 6, Hkv, D)).astype(np.float32)
    jc = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.int8)
    tc = tkv.make_cache(L, N, Bs, Hkv, D, dtype=torch.int8, device="cpu")
    assert tc.quantized and tc.ks.shape == (L, N, Hkv, Bs)
    jl, js = jkv.write_chunk_q(jc.k[0], jc.ks[0], jnp.asarray(new),
                               jnp.asarray(tables), jnp.asarray(positions),
                               valid=jnp.asarray(valid))
    tl, ts = tkv.write_chunk_q(tc.k[0], tc.ks[0], _t(new), _t(tables),
                               _t(positions), valid=_t(valid))
    assert tl.data_ptr() == tc.k[0].data_ptr()   # in place
    np.testing.assert_array_equal(tl.numpy()[1:], _np(jl)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], _np(js)[1:])
    assert np.abs(tl.numpy()[1:]).sum() > 0
    for dt in ("float32", "bfloat16"):
        want = jkv.gather_view_q(jl, js, jnp.asarray(tables), 3,
                                 dtype=getattr(jnp, dt))
        got = tkv.gather_view_q(tl, ts, _t(tables), 3,
                                dtype=getattr(torch, dt))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# --------------------------------------------- paged attention, int8 pool

def _int8_case(T, lens, Bs=16, Hkv=2, G=2, D=32, n_blocks=64, seed=0,
               q_scale=1.0):
    """An int8 pool quantized by JAX from random f32 K/V, shuffled
    tables, q [B, T, H, D] f32 (numpy)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    MB = -(-(max(lens) + T) // Bs)
    k8, ks = jkv.quantize_chunk(jnp.asarray(
        rng.standard_normal((n_blocks, Hkv, Bs, D)).astype(np.float32)))
    v8, vs = jkv.quantize_chunk(jnp.asarray(
        rng.standard_normal((n_blocks, Hkv, Bs, D)).astype(np.float32)))
    tables = (rng.permutation(n_blocks - 1)[:B * MB] + 1).reshape(
        B, MB).astype(np.int32)
    q = (rng.standard_normal((B, T, Hkv * G, D)) * q_scale).astype(
        np.float32)
    return (q, _np(k8), _np(v8), _np(ks), _np(vs), tables,
            np.array(lens, np.int32), MB)


@pytest.mark.parametrize("T,window,softcap,q_scale", [
    (1, 0, 0.0, 1.0), (5, 0, 0.0, 1.0), (48, 0, 0.0, 1.0),
    # a window of 20 over blocks of 16 and a softcap of 5 on raw scores
    # of about +-20 (q x 10)
    (5, 20, 5.0, 10.0), (24, 20, 5.0, 10.0)])
def test_plain_paged_int8_matches_pallas_int8(T, window, softcap, q_scale):
    """The wrappers on CPU tensors (the plain version over gather_view_q)
    against the Pallas kernels' int8 branches (k_scales/v_scales) in
    interpret mode, f32, the decode kernel for T <= 8; no launch is
    counted."""
    q, k8, v8, ks, vs, tables, starts, nb = _int8_case(
        T, [40, 23], seed=T, q_scale=q_scale)
    jfn, tfn = ((pallas_paged_decode_attention, tpa.paged_decode_attention)
                if T <= tpa.DECODE_T_MAX
                else (pallas_paged_attention, tpa.paged_attention))
    want = _np(jfn(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                   jnp.asarray(tables), jnp.asarray(starts), nb=nb,
                   interpret=True, k_scales=jnp.asarray(ks),
                   v_scales=jnp.asarray(vs), window=window,
                   softcap=softcap))
    before = dict(tpa.launch_counts), dict(tpa.int8_launches)
    got = tfn(_t(q), _t(k8), _t(v8), _t(tables), _t(starts), nb=nb,
              k_scales=_t(ks), v_scales=_t(vs), window=window,
              softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (dict(tpa.launch_counts), dict(tpa.int8_launches)) == before


def test_plain_paged_int8_bf16_matches_pallas_int8():
    """bf16 q over the int8 pool, both kernels' shapes, against the Pallas
    int8 branch in interpret mode (3e-2: see the module doc)."""
    for T in (5, 24):
        q, k8, v8, ks, vs, tables, starts, nb = _int8_case(
            T, [40, 23], seed=10 + T)
        jq = jnp.asarray(q, _BF16)
        jfn, tfn = ((pallas_paged_decode_attention,
                     tpa.paged_decode_attention) if T <= 8
                    else (pallas_paged_attention, tpa.paged_attention))
        want = np.asarray(jfn(jq, jnp.asarray(k8), jnp.asarray(v8),
                              jnp.asarray(tables), jnp.asarray(starts),
                              nb=nb, interpret=True,
                              k_scales=jnp.asarray(ks),
                              v_scales=jnp.asarray(vs)), np.float32)
        got = tfn(_t(np.asarray(jq, np.float32)).to(torch.bfloat16), _t(k8),
                  _t(v8), _t(tables), _t(starts), nb=nb, k_scales=_t(ks),
                  v_scales=_t(vs))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=3e-2)


@pytest.mark.parametrize("kw,match", [
    (dict(int8_pool=True), "both"),
    (dict(int8_pool=True, k_scales=True), "both"),
    (dict(k_scales=True, v_scales=True), "int8 pool only"),
    (dict(int8_pool=True, k_scales=True, v_scales=True, bad_shape=True),
     "float32"),
])
def test_int8_pool_and_scales_go_together(kw, match):
    """An int8 pool without both scales, scales without an int8 pool, or
    scales of another shape raise on the CPU as on the card."""
    q, k8, v8, ks, vs, tables, starts, nb = _int8_case(1, [5])
    k, v = _t(k8), _t(v8)
    if not kw.get("int8_pool"):
        k, v = k.float(), v.float()
    ksc, vsc = _t(ks), _t(vs)
    if kw.get("bad_shape"):
        ksc = ksc[:, :, :4]
    with pytest.raises(ValueError, match=match):
        tpa.paged_decode_attention(
            _t(q), k, v, _t(tables), _t(starts), nb=nb,
            k_scales=ksc if kw.get("k_scales") else None,
            v_scales=vsc if kw.get("v_scales") else None)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_int8_prefill_tile_fits_a_block(D):
    """The bf16 prefill tile over an int8 pool adds each stage's 64 K and
    64 V f32 scales to the ring and still fits the 232,448 bytes a block
    may use (the panels are cast to bf16 as they land, so the ring is
    the bf16 one)."""
    tile, tile8 = tpa.prefill_tile(D), tpa.prefill_tile(D, int8=True)
    assert tile8["smem_bytes"] == tile["smem_bytes"] + \
        tile["stages"] * 2 * tile["keys"] * 4
    assert tile8["smem_bytes"] <= 232448


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("model", ["debug-tiny", "debug-gemma2",
                                   "debug-moe"])
def test_forward_int8_weights_and_pool_matches_jax(model):
    """JAX-quantized weights carried across bit for bit (params_from_jax
    of the {"w8", "scale"} leaves) and an int8 pool carried across with
    its scales: two prefill chunks, then decode steps (debug-gemma2 past
    its 64-token window), f32 logits against JAX llama.forward.

    Rounding to int8 is discontinuous: a K/V value whose f32 quotient
    lies within an ulp of a .5 boundary may round the other way on the
    two sides, whose projections sum in another order (debug-tiny on the
    CPU at this seed: one V value of layer 1 in the first chunk, which
    moves the logits by 1.6e-4). So after each step the pools must be
    equal outside block 0 but for such ties — one int8 step each, at most
    1 in 1000 written values — and the logits agree to 1e-4 while no tie
    has happened, to 1e-3 after one."""
    jcfg, tcfg, params = _jax_params(model, "float32", 5)
    jparams = jquant.quantize_params(params)
    tmodel = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             tcfg, device="cpu")
    assert tquant.is_quantized(tmodel.q) and tquant.is_quantized(tmodel.embed)
    rng = np.random.default_rng(9)
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    B, Bs, MB, N = 2, 16, 6, 14
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.int8)
    tcache, ttables = cache_from_jax(_np(jcache.k), _np(jcache.v), tables,
                                     device="cpu", ks=_np(jcache.ks),
                                     vs=_np(jcache.vs))
    assert tcache.quantized and tcache.k.dtype == torch.int8

    written = 0

    def check(tokens, positions, kv_len):
        nonlocal jcache, written
        jl, jcache = jllama.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jcache, block_tables=jnp.asarray(tables), kv_len=kv_len)
        tl, _ = tllama.forward(tmodel, tcfg, _t(tokens), _t(positions),
                               tcache, block_tables=ttables, kv_len=kv_len)
        written += 2 * L * tokens.size * Hkv * D
        ties = 0
        for ours, theirs in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            d = np.abs(ours.numpy()[:, 1:].astype(np.int16)
                       - _np(theirs)[:, 1:].astype(np.int16))
            assert d.max() <= 1
            ties += int((d != 0).sum())
        assert ties * 1000 <= written, (ties, written)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0,
                                   atol=1e-4 if ties == 0 else 1e-3)

    for lo, hi in ((0, 40), (40, 72)):
        tokens = rng.integers(0, jcfg.vocab_size, (B, hi - lo)).astype(
            np.int32)
        positions = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                    (B, hi - lo)).copy()
        check(tokens, positions, kv_len=hi)
    for pos in range(72, 76):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        check(tok, np.full((B, 1), pos, np.int32), kv_len=80)
    np.testing.assert_allclose(tcache.ks.numpy()[:, 1:],
                               _np(jcache.ks)[:, 1:], rtol=1e-6, atol=0)


# ------------------------------------------------------- engine and server

def _int8_engines_tokens(model):
    """Greedy tokens of five prompts of mixed lengths through three slots
    (chunked prefill interleaved with decode windows) from a JAX and a
    port engine on the same f32 weights, each quantizing them itself,
    weights and KV both int8: (port's, JAX's)."""
    _, tcfg, params = _jax_params(model, "float32", 2)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    common = dict(model=model, dtype="float32", kv_dtype="int8",
                  quantization="int8", max_model_len=128, max_num_seqs=3,
                  prefill_chunk=32, prefill_buckets=(16, 32),
                  decode_window=4, kv_block_size=8)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=params)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    assert te.runner.cache.quantized and tquant.is_quantized(
        te.runner.params.gate)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 70, 12)]
    prompts.append(prompts[1][:33] + [7, 7])
    budgets = (10, 6, 12, 20, 8)

    def run(engine, opts_cls):
        ids = [engine.add_request(p, opts_cls(temperature=0.0,
                                              max_tokens=m,
                                              ignore_eos=True))
               for p, m in zip(prompts, budgets)]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]

    got = run(te, SamplingOptions)
    assert [len(t) for t in got] == list(budgets)
    return got, run(je, JSamplingOptions)


def test_engine_int8_greedy_tokens_equal_jax_engine_mixed_batch():
    """Weights and KV both int8 (f32 activations), debug-tiny: greedy
    tokens equal the JAX engine's, sequence by sequence."""
    got, want = _int8_engines_tokens("debug-tiny")
    assert got == want


def test_engine_int8_moe_greedy_tokens_equal_jax_engine_mixed_batch():
    """The same at debug-moe: the int8 expert stacks through the capacity
    dispatch (prefill) and the exact path (decode) in both engines;
    greedy tokens equal the JAX engine's, sequence by sequence."""
    got, want = _int8_engines_tokens("debug-moe")
    assert got == want


@pytest.mark.parametrize("kw", [dict(kv_dtype="int4"),
                                dict(quantization="fp8")])
def test_engine_config_refuses_other_int8_modes(kw):
    """The JAX validation: only int8 weights and an int8 pool."""
    with pytest.raises(ValueError, match="unsupported"):
        tec.EngineConfig(model="debug-tiny", device="cpu", **kw)


def test_server_accepts_int8_flags_and_serves():
    """--quantization int8 --kv-cache-dtype int8 reach the engine, whose
    server answers a completion."""
    args = parse_args(["--device", "cpu", "--quantization", "int8",
                       "--kv-cache-dtype", "int8"])
    assert (args.quantization, args.kv_cache_dtype) == ("int8", "int8")
    eng = AsyncLLMEngine(tec.EngineConfig(
        model="debug-tiny", device=args.device, max_model_len=128,
        max_num_seqs=2, prefill_chunk=32, prefill_buckets=(16, 32),
        decode_window=4, quantization=args.quantization,
        kv_dtype=args.kv_cache_dtype))
    assert eng.engine.runner.cache.k.dtype == torch.int8

    async def body():
        async with TestClient(TestServer(
                build_app(eng, api_key=""))) as client:
            r = await client.post("/v1/completions", json={
                "model": "debug-tiny", "prompt": "int8 weights and kv",
                "max_tokens": 5, "temperature": 0.0, "ignore_eos": True})
            assert r.status == 200
            assert (await r.json())["usage"]["completion_tokens"] == 5
    try:
        asyncio.run(body())
    finally:
        eng.stop()
