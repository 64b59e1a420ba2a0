"""The port's tensor- and expert-parallel serving (parallel/) against the
JAX package on the CPU, at debug sizes and float32.

- Shards: every rank slice of every leaf (int8 {w8, scale} leaves
  included) and of the KV pool equals the per-device shard JAX's
  NamedShardings give the same array, bit for bit.
- The sharded forward: ranks built in threads of this process (one
  gloo group over an in-memory store) run llama.forward on their
  shards; every rank's logits are the same bytes, and they equal the
  JAX single-device forward's to 1e-5 (f32: the tp partial sums add in
  another order than one matmul).
- Engines: rank 0 in this process, the other ranks spawned. Greedy
  tokens of debug-tiny at tp = 2 equal the JAX single-device engine's
  and the JAX tp = 2 engine's in the cases of the JAX package's
  dry-run feature pass (speculative, guided, a prefix-cache hit,
  shaped) and over the int8 pool; debug-moe at ep = 2 and ep = 2 x
  tp = 2 equal JAX's single-device and ep-mesh engines on both MoE
  paths; LoRA and KV tiers at tp = 2 equal tp = 1; the refusals are
  JAX's; a worker samples rank 0's tokens; a killed worker makes the
  engine raise; close() leaves no process.
"""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import \
    SamplingOptions as JSamplingOptions
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import quant as jquant
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import sharding as jsharding

from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app, parse_args
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops import moe as tmoe
from production_stack_tpu_torch.parallel import sharding as tsharding
from production_stack_tpu_torch.parallel import workers as tworkers
from production_stack_tpu_torch.parallel.mesh import (MeshConfig,
                                                      ServingMesh, Shard,
                                                      choose_backend)
from production_stack_tpu_torch.weights import (cache_from_jax,
                                                params_from_jax)

from tests.torch_geometry import FIXED

# float32 logits of the sharded forward against JAX's single device
LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models, thousands of small ops: one intra-op thread keeps
    them fast when other test processes hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# HF config of tests/test_torch_families.py's tiny Qwen2-MoE: q/k/v
# biases, 4 experts, a shared expert
TINY_QWEN2_MOE = {
    "model_type": "qwen2_moe", "vocab_size": 256, "hidden_size": 64,
    "intermediate_size": 128, "moe_intermediate_size": 48,
    "shared_expert_intermediate_size": 96, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "num_experts": 4, "num_experts_per_tok": 2,
    "norm_topk_prob": False, "decoder_sparse_step": 1,
    "mlp_only_layers": [], "tie_word_embeddings": False}


def _pair(model, seed=0, quantize=False):
    """(jcfg, tcfg, JAX params, numpy params) of one f32 weight set;
    biases drawn N(0, 0.1) where the model has them."""
    if model == "tiny-qwen2-moe":
        jcfg = jconfig.ModelConfig.from_hf_config(
            TINY_QWEN2_MOE, name=model, dtype=jnp.float32)
        tcfg = tconfig.ModelConfig.from_hf_config(
            TINY_QWEN2_MOE, name=model, dtype=torch.float32)
    else:
        jcfg = dataclasses.replace(jconfig.get_config(model),
                                   dtype=jnp.float32)
        tcfg = dataclasses.replace(tconfig.get_config(model),
                                   dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    if jcfg.attention_bias:
        rng = np.random.default_rng(seed + 100)
        for name in ("q_bias", "k_bias", "v_bias"):
            shape = jparams["layers"][name].shape
            jparams["layers"][name] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
    if quantize:
        jparams = jquant.quantize_params(jparams)
    return jcfg, tcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _jax_mesh(tp, ep):
    return jmesh.build_mesh(jmesh.MeshConfig(dp=1, sp=1, tp=tp, ep=ep),
                            jax.devices()[:tp * ep])


def _device_shards(jmesh_, x, spec):
    """{Shard: numpy block} of x placed with `spec` on the JAX mesh."""
    from jax.sharding import NamedSharding
    arr = jax.device_put(x, NamedSharding(jmesh_, spec))
    devs = np.asarray(jmesh_.devices).reshape(-1)
    tp, ep = jmesh_.shape["tp"], jmesh_.shape["ep"]
    out = {}
    for sh in arr.addressable_shards:
        rank = int(np.flatnonzero(devs == sh.device)[0])
        out[Shard(tp=tp, ep=ep, tp_rank=rank % tp, ep_rank=rank // tp)] = \
            np.asarray(sh.data)
    return out


def _flat(tree, prefix=""):
    """(path, leaf) of a params or spec tree; an int8 leaf's w8 and
    scale as two paths."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_config_factors_devices_as_jax(n):
    """MeshConfig.for_devices and the axes are JAX's; a serving world's
    rank coordinates put tp innermost, as JAX's device array does."""
    from production_stack_tpu_torch.parallel import mesh as tmesh
    assert tmesh.AXES == jmesh.AXES
    for tp in (None, 1, 2):
        if tp and n % tp:
            continue
        assert dataclasses.asdict(tmesh.MeshConfig.for_devices(n, tp)) == \
            dataclasses.asdict(jmesh.MeshConfig.for_devices(n, tp))
    if n in (2, 4, 8):
        devs = np.arange(n).reshape(1, 1, 1, 2 if n > 2 else 1, -1)
        cfg = MeshConfig(tp=devs.shape[-1], ep=devs.shape[-2])
        for r in range(n):
            s = Shard.of(cfg, r)
            assert devs[0, 0, 0, s.ep_rank, s.tp_rank] == r


def test_rules_are_the_jax_rules():
    """The port's rules are JAX's, name for name and axis for axis."""
    assert set(tsharding._LAYER_SPECS) == set(jsharding._LAYER_SPECS)
    assert set(tsharding._MOE_SPECS) == set(jsharding._MOE_SPECS)
    for ours, theirs in ((tsharding._LAYER_SPECS, jsharding._LAYER_SPECS),
                         (tsharding._MOE_SPECS, jsharding._MOE_SPECS)):
        for name, spec in ours.items():
            assert spec == tuple(theirs[name]), name
    assert tsharding.cache_pspec() == tuple(jsharding.cache_pspec())
    assert tsharding.cache_scale_pspec() == \
        tuple(jsharding.cache_scale_pspec())


@pytest.mark.parametrize("model,tp,ep,quantize", [
    ("debug-tiny", 2, 1, False),
    ("debug-tiny", 2, 1, True),
    ("debug-gemma2", 2, 1, False),
    ("tiny-qwen2-moe", 2, 2, False),
    ("tiny-qwen2-moe", 2, 2, True),
    ("debug-moe", 1, 2, True),
])
def test_rank_slices_equal_jax_shards(model, tp, ep, quantize):
    """Every leaf's rank slice (the carried weights cut by
    params_from_jax(shard=...)) equals JAX's per-device shard of
    param_shardings, bit for bit, and the spec trees agree."""
    _, tcfg, jparams, np_params = _pair(model, 1, quantize)
    jm = _jax_mesh(tp, ep)
    full = params_from_jax(np_params, tcfg, device="cpu")
    jspecs = jsharding.param_pspecs(jparams)
    tspecs = tsharding.param_pspecs(full)
    jflat = dict(_flat(jspecs))
    assert {k: tuple(v) for k, v in jflat.items()} == dict(_flat(tspecs))
    leaves = dict(_flat(np_params))
    shards = {Shard.of(MeshConfig(tp=tp, ep=ep), r): None
              for r in range(tp * ep)}
    for s in shards:
        # the carried weights cut per rank (weights.params_from_jax)
        shards[s] = params_from_jax(np_params, tcfg, device="cpu", shard=s)
        assert shards[s].shard == s
    seen = 0
    for path, spec in jflat.items():
        want = _device_shards(jm, leaves[path], spec)
        name, _, part = path.replace("layers.", "").partition(".")
        for s, mod in shards.items():
            got = getattr(mod, name)
            got = getattr(got, part) if part else got
            np.testing.assert_array_equal(got.numpy(), want[s], err_msg=path)
        seen += 1
    assert seen == len(leaves)


@pytest.mark.parametrize("int8", [False, True])
def test_kv_pool_heads_equal_jax_shards(int8):
    """A rank's pool heads (sharding.shard_cache) and the int8 pool's
    scales equal JAX's per-device shards of cache_pspec /
    cache_scale_pspec; kv_heads and head_slice agree."""
    rng = np.random.default_rng(3)
    L, N, Hkv, Bs, D = 2, 5, 4, 8, 16
    k = rng.standard_normal((L, N, Hkv, Bs, D)).astype(np.float32)
    v = rng.standard_normal((L, N, Hkv, Bs, D)).astype(np.float32)
    ks = vs = None
    if int8:
        k = rng.integers(-127, 128, k.shape).astype(np.int8)
        v = rng.integers(-127, 128, v.shape).astype(np.int8)
        ks = rng.random((L, N, Hkv, Bs)).astype(np.float32)
        vs = rng.random((L, N, Hkv, Bs)).astype(np.float32)
    cache, _ = cache_from_jax(k, v, device="cpu", ks=ks, vs=vs)
    for tp in (2, 4):
        jm = _jax_mesh(tp, 1)
        want_k = _device_shards(jm, k, jsharding.cache_pspec())
        for s, wk in want_k.items():
            mine = tsharding.shard_cache(cache, s)
            np.testing.assert_array_equal(mine.k.numpy(), wk)
            assert mine.k.shape[2] == Hkv // tp
            hs = tsharding.head_slice(s, Hkv)
            np.testing.assert_array_equal(mine.v.numpy(), v[:, :, hs])
            if int8:
                want_s = _device_shards(jm, ks, jsharding.cache_scale_pspec())
                np.testing.assert_array_equal(mine.ks.numpy(), want_s[s])


# ------------------------------------------------------- sharded forward

def _threaded_world(mesh_cfg, fn):
    """fn(mesh) on every rank of a gloo world of threads (one in-memory
    store); the ranks' results in rank order."""
    store = dist.HashStore()
    out, errs = [None] * mesh_cfg.size, []

    def rank_main(r):
        try:
            out[r] = fn(ServingMesh(mesh_cfg, r, store,
                                    torch.device("cpu"), 60.0))
        except Exception as e:   # noqa: BLE001 — re-raised below
            errs.append(e)
    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(mesh_cfg.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("model,tp,ep,quantize,chunk", [
    ("debug-tiny", 2, 1, False, 12),
    ("debug-tiny", 2, 1, True, 12),
    ("debug-gemma2", 2, 1, False, 12),
    # N = 3 x 32 tokens at capacity factor 0.5: the dispatch path drops;
    # the decode steps (T = 1) take the exact path
    ("debug-moe", 1, 2, False, 32),
    ("debug-moe", 2, 2, False, 32),
    ("tiny-qwen2-moe", 2, 2, False, 32),
])
def test_sharded_forward_logits_equal_jax(model, tp, ep, quantize, chunk):
    """A prefill chunk (ragged, right padding masked) then two decode
    steps through every rank's shard, pool heads and collectives: the
    ranks' logits are the same bytes, and equal the JAX single-device
    forward's on the same weights and pool to LOGIT_ATOL."""
    jcfg, tcfg, jparams, np_params = _pair(model, 2, quantize)
    if jcfg.num_experts:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    rng = np.random.default_rng(4)
    B, Bs, L, Hkv, D = 3, 8, jcfg.num_layers, jcfg.num_kv_heads, \
        jcfg.head_dim_
    MB = -(-(chunk + 2) // Bs) + 1
    N = B * MB + 2
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.float32)
    steps = []
    tokens = rng.integers(0, jcfg.vocab_size, (B, chunk)).astype(np.int32)
    valid = np.arange(chunk)[None, :] < np.array([chunk, chunk - 5, 3])[:,
                                                                       None]
    steps.append((tokens, np.broadcast_to(np.arange(chunk, dtype=np.int32),
                                          (B, chunk)).copy(), valid, chunk))
    for i in range(2):
        steps.append((rng.integers(0, jcfg.vocab_size, (B, 1)).astype(
            np.int32), np.full((B, 1), chunk + i, np.int32),
            np.ones((B, 1), bool), chunk + 2))
    want = []
    for tok, pos, val, kv_len in steps:
        jl, jcache = jllama.forward(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
            block_tables=jnp.asarray(tables), kv_len=kv_len,
            token_valid=jnp.asarray(val))
        want.append(np.asarray(jl))
    full = params_from_jax(np_params, tcfg, device="cpu")
    pool = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.float32)

    def rank(mesh):
        params = tsharding.shard_params(full, mesh.shard)
        params.mesh = mesh
        cache, ttables = cache_from_jax(np.asarray(pool.k),
                                        np.asarray(pool.v), tables,
                                        dtype=torch.float32, device="cpu")
        cache = tsharding.shard_cache(cache, mesh.shard)
        out = []
        for tok, pos, val, kv_len in steps:
            logits, _ = tllama.forward(
                params, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
                cache, block_tables=ttables, kv_len=kv_len,
                token_valid=torch.from_numpy(val))
            out.append(logits.numpy())
        return out

    got = _threaded_world(MeshConfig(tp=tp, ep=ep), rank)
    for r in range(1, tp * ep):
        for a, b in zip(got[0], got[r]):
            np.testing.assert_array_equal(a, b)
    for (tok, pos, val, _), g, w in zip(steps, got[0], want):
        np.testing.assert_allclose(g[val], w[val], rtol=0, atol=LOGIT_ATOL)


# --------------------------------------------------------------- engines

_TINY = dict(model="debug-tiny", max_model_len=128, max_num_seqs=2,
             prefill_chunk=32, prefill_buckets=(32,), decode_window=4,
             dtype="float32", kv_dtype="float32")


def _jax_engine(params, **kw):
    return jengine.LLMEngine(jec.EngineConfig(**FIXED, **kw),
                             params=params)


def _port_engine(np_params, **kw):
    # the JAX engines here are pinned to the fixed decode geometry: so
    # is the port's side, unless a test asks for the windows
    cfg = tec.EngineConfig(device="cpu", **dict(FIXED, **kw))
    tcfg = dataclasses.replace(tconfig.get_config(cfg.model),
                               dtype=torch.float32)
    return tengine.LLMEngine(cfg, params=params_from_jax(np_params, tcfg,
                                                         device="cpu"))


def _drain(engine, ids):
    while engine.has_work:
        engine.step()
    return [engine.seqs[i].output_tokens for i in ids]


def _feature_pass(engine, opts_cls):
    """The JAX dry run's feature pass (__graft_entry__._feature_pass):
    speculative greedy rows, a guided row, the first prompt again (a
    prefix-cache hit), a shaped row; then the hit rate."""
    opts = opts_cls(temperature=0.0, max_tokens=8, ignore_eos=True)
    prompts = [[7, 8, 9] * 13 + [7], [5, 6] * 20]
    out = {"plain": _drain(engine, [engine.add_request(p, opts)
                                    for p in prompts])}
    out["guided"] = _drain(engine, [engine.add_request(
        engine.tokenizer.encode("pick"),
        opts_cls(temperature=0.0, max_tokens=12,
                 guided_regex=r"(one|two|three)", ignore_eos=True))])
    out["prefix_hit"] = _drain(engine, [engine.add_request(prompts[0],
                                                           opts)])
    out["shaped"] = _drain(engine, [engine.add_request(
        prompts[1], opts_cls(temperature=0.0, max_tokens=8,
                             ignore_eos=True, presence_penalty=2.0,
                             min_tokens=6))])
    out["hit_rate"] = engine.block_mgr.hit_rate
    return out


@pytest.fixture(scope="module")
def feature_runs():
    """The feature pass through the JAX single-device engine, the JAX
    tp = 2 engine and the port's tp = 2 engine on one weight set."""
    _, _, jparams, np_params = _pair("debug-tiny", 3)
    cfg = dict(_TINY, speculative_ngram_tokens=3, kv_block_size=16,
               enable_prefix_caching=True)
    runs = {"jax": _feature_pass(_jax_engine(jparams, **cfg),
                                 JSamplingOptions),
            "jax_tp2": _feature_pass(_jax_engine(
                jparams, tensor_parallel_size=2, **cfg), JSamplingOptions)}
    te = _port_engine(np_params, tensor_parallel_size=2, **cfg)
    try:
        runs["port_tp2"] = _feature_pass(te, SamplingOptions)
    finally:
        te.close()
    return runs


@pytest.mark.parametrize("case", ["plain", "guided", "prefix_hit",
                                  "shaped"])
def test_tp2_engine_feature_pass_equals_jax(feature_runs, case):
    """Greedy tokens of the port's tp = 2 engine equal the JAX
    single-device engine's and the JAX tp = 2 engine's, case by case;
    the re-sent prompt hit the prefix cache and gave the first run's
    tokens."""
    got = feature_runs["port_tp2"][case]
    assert got == feature_runs["jax"][case]
    assert got == feature_runs["jax_tp2"][case]
    if case == "prefix_hit":
        assert feature_runs["port_tp2"]["hit_rate"] > 0
        assert got[0] == feature_runs["port_tp2"]["plain"][0]


def test_tp2_engine_int8_kv_equals_jax():
    """Over the int8 pool (each rank quantizes its heads): tokens of
    mixed-length prompts equal the JAX single-device and tp = 2
    engines'."""
    _, _, jparams, np_params = _pair("debug-tiny", 4)
    cfg = dict(_TINY, kv_dtype="int8", kv_block_size=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 45, 70)]

    def run(engine, opts_cls):
        return _drain(engine, [engine.add_request(
            p, opts_cls(temperature=0.0, max_tokens=10, ignore_eos=True))
            for p in prompts])
    want = run(_jax_engine(jparams, **cfg), JSamplingOptions)
    assert run(_jax_engine(jparams, tensor_parallel_size=2, **cfg),
               JSamplingOptions) == want
    te = _port_engine(np_params, tensor_parallel_size=2, **cfg)
    try:
        assert run(te, SamplingOptions) == want
    finally:
        te.close()


def test_tp2_engine_with_adaptive_windows_equals_tp1():
    """Continuous batching across windows at tp = 2: staggered budgets
    on 4 slots take the windows through batch buckets 4, 2 and 1 with
    windows dispatched ahead; every rank runs rank 0's bucket (the
    worker's last window has rank 0's shape and tokens), and the tokens
    and the window sequence equal the tp = 1 engine's."""
    _, _, _, np_params = _pair("debug-tiny", 5)
    cfg = dict(_TINY, max_num_seqs=4, window_adapt=True, pipeline_depth=2)
    prompts = [list(range(5 + i, 15 + i)) for i in range(5)]

    def run(engine):
        out = _drain(engine, [engine.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=6 + 5 * i, ignore_eos=True))
            for i, p in enumerate(prompts)])
        return out, [(w["batch"], w["steps"], w["live_rows"])
                     for w in engine.eff._windows]

    want = run(_port_engine(np_params, **cfg))
    assert {w[0] for w in want[1]} == {1, 2, 4}
    te = _port_engine(np_params, tensor_parallel_size=2, **cfg)
    try:
        assert run(te) == want
        ranks = te.runner.last_results("decode")
        assert ranks[0][0].shape[0] == 1
        assert torch.equal(ranks[0][0], ranks[1][0])
    finally:
        te.close()


@pytest.mark.parametrize("tp,ep", [(1, 2), (2, 2)])
def test_moe_engine_equals_jax_on_both_paths(tp, ep):
    """debug-moe at capacity factor 0.5: chunked prefill of 3 x 32
    tokens takes the dispatch path (capacity 24 of 96: dropping), decode
    the exact path. The port at ep (x tp) gives the tokens of the JAX
    single-device engine and of the JAX ep mesh engine."""
    _, _, jparams, np_params = _pair("debug-moe", 5)
    cfg = dict(_TINY, model="debug-moe", moe_capacity_factor=0.5,
               max_num_seqs=3)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 70, 12)]

    def run(engine, opts_cls):
        return _drain(engine, [engine.add_request(
            p, opts_cls(temperature=0.0, max_tokens=8, ignore_eos=True))
            for p in prompts])
    want = run(_jax_engine(jparams, **cfg), JSamplingOptions)
    assert run(_jax_engine(jparams, tensor_parallel_size=tp,
                           expert_parallel_size=ep, **cfg),
               JSamplingOptions) == want
    te = _port_engine(np_params, tensor_parallel_size=tp,
                      expert_parallel_size=ep, **cfg)
    paths = {"exact": 0, "dispatch": 0}
    saved = tmoe._moe_exact, tmoe._moe_dispatch

    def counted(kind, fn):
        def call(*a, **kw):
            paths[kind] += 1
            return fn(*a, **kw)
        return call
    tmoe._moe_exact = counted("exact", saved[0])
    tmoe._moe_dispatch = counted("dispatch", saved[1])
    try:
        assert run(te, SamplingOptions) == want
        assert paths["exact"] > 0 and paths["dispatch"] > 0
        # the world's combine ran: every rank's partials were summed
        assert te.runner.mesh.calls["world.all_reduce"] > 0
    finally:
        tmoe._moe_exact, tmoe._moe_dispatch = saved
        te.close()


def test_lora_tp2_equals_tp1_with_a_runtime_load():
    """Adapters on all seven projections, one at start and one loaded at
    runtime (it reaches every rank): a batch of base + both adapters
    gives the same tokens at tp = 2 as at tp = 1."""
    _, _, _, np_params = _pair("debug-tiny", 6)
    cfg = dict(_TINY, max_num_seqs=3, lora_adapters={"a1": "random:1"},
               lora_rank=4, lora_alpha=8.0,
               lora_targets=("q", "k", "v", "o", "gate", "up", "down"))
    prompt = list(range(30, 60))

    def run(engine):
        engine.load_adapter("a2", "random:2")
        opts = SamplingOptions(temperature=0.0, max_tokens=8,
                               ignore_eos=True)
        return _drain(engine, [engine.add_request(prompt, opts, model=m)
                               for m in (None, "a1", "a2")])
    want = run(_port_engine(np_params, **cfg))
    assert len({tuple(t) for t in want}) == 3
    te = _port_engine(np_params, tensor_parallel_size=2, **cfg)
    try:
        assert run(te) == want
    finally:
        te.close()


def test_tier_chunks_of_tp2_match_tp1_and_a_tp2_consumer_serves(tmp_path):
    """A tp = 2 producer publishes the chunks a tp = 1 producer
    publishes: the same keys, the same wire layout and size, K/V equal
    to 1e-5 (the tp partial sums round in another order, so the bytes of
    layers past the first may differ in the last bit); a tp = 2 consumer
    injects them (each rank its heads) and gives the producer's tokens.
    For the same KV the chunks are the same bytes: a chunk injected
    into a tp = 2 engine extracts byte for byte as from a tp = 1
    engine, over the f32 and over the int8 pool."""
    _, _, _, np_params = _pair("debug-tiny", 7)
    prompt = list(range(40, 104))       # two publishable chunks

    def tier(role, path, **kw):
        return dict(_TINY, **kw, kv_transfer_config={
            "kv_role": role, "chunk_size": 32, "local_cpu_gb": 0,
            "local_disk_path": str(path)})

    def serve(engine):
        sid = engine.add_request(prompt, SamplingOptions(
            temperature=0.0, max_tokens=8, ignore_eos=True))
        out = _drain(engine, [sid])[0]
        engine.connector.flush()
        return out

    def chunks(path):
        # a disk-tier file is the value: k and v bytes, then the digest
        return {p.name: np.frombuffer(p.read_bytes()[:-8], np.float32)
                for p in sorted(path.rglob("*")) if p.is_file()}

    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 32, 2, 32), generator=g)
    v = torch.randn((2, 32, 2, 32), generator=g)
    one, two = tmp_path / "tp1", tmp_path / "tp2"
    extracted = {}
    for tp, path in ((1, one), (2, two)):
        for kv in ("float32", "int8"):
            e = _port_engine(np_params, tensor_parallel_size=tp,
                             **tier("kv_producer", path / kv, kv_dtype=kv))
            try:
                if kv == "float32":
                    extracted[tp, "served"] = serve(e)
                e.runner.inject_chunk(0, 0, k, v)
                extracted[tp, kv] = e.runner.extract_chunk(0, 0, 32)
            finally:
                e.close()
    assert extracted[2, "served"] == extracted[1, "served"]
    for part in range(2):
        assert torch.equal(extracted[2, "float32"][part], (k, v)[part])
        assert torch.equal(extracted[1, "float32"][part], (k, v)[part])
        assert torch.equal(extracted[2, "int8"][part],
                           extracted[1, "int8"][part])
    c1, c2 = chunks(one / "float32"), chunks(two / "float32")
    assert c1 and set(c1) == set(c2)
    for key in c1:
        np.testing.assert_allclose(c2[key], c1[key], rtol=0, atol=1e-5)
    c = _port_engine(np_params, tensor_parallel_size=2,
                     **tier("kv_consumer", two / "float32"))
    try:
        assert serve(c) == extracted[1, "served"]
        assert c.connector.hit_tokens > 0
    finally:
        c.close()


@pytest.mark.parametrize("model,kw,err,match", [
    ("debug-tiny", dict(tensor_parallel_size=8), ValueError,
     "num_kv_heads"),
    ("debug-tiny", dict(expert_parallel_size=2), ValueError, "dense"),
    ("debug-moe", dict(expert_parallel_size=3), ValueError,
     "num_experts"),
    ("debug-tiny", dict(pipeline_parallel_size=2), NotImplementedError,
     "pipeline-parallel"),
])
def test_refusals_match_jax(model, kw, err, match):
    """The mesh refusals of both engines, with the same messages."""
    common = dict(model=model, max_model_len=64, max_num_seqs=1,
                  prefill_chunk=16, prefill_buckets=(16,))
    with pytest.raises(err, match=match):
        tengine.LLMEngine(tec.EngineConfig(device="cpu", **common, **kw))
    with pytest.raises(err, match=match):
        jengine.LLMEngine(jec.EngineConfig(**common, **kw))


def test_engine_config_takes_parallel_sizes_and_the_server_flags():
    """tensor_parallel_size / expert_parallel_size are taken (no longer
    refused); the server parses the JAX server's three flags; the
    backend rule."""
    cfg = tec.EngineConfig(model="debug-moe", device="cpu",
                           tensor_parallel_size=2, expert_parallel_size=2)
    assert (cfg.tensor_parallel_size, cfg.expert_parallel_size) == (2, 2)
    args = parse_args(["--tensor-parallel-size", "2",
                       "--expert-parallel-size", "2",
                       "--pipeline-parallel-size", "1"])
    assert (args.tensor_parallel_size, args.expert_parallel_size,
            args.pipeline_parallel_size) == (2, 2, 1)
    assert choose_backend(torch.device("cpu"), 2) == "gloo"


def test_worker_samples_rank0_tokens_and_close_leaves_no_process():
    """Sampled rows (unseeded from the runners' generators, and seeded):
    every rank's last decode window holds rank 0's tokens, so no
    broadcast is needed; close() stops and joins every worker."""
    _, _, _, np_params = _pair("debug-tiny", 8)
    te = _port_engine(np_params, tensor_parallel_size=2,
                      **dict(_TINY, max_num_seqs=3))
    procs = te.runner.workers
    try:
        ids = [te.add_request(list(range(10, 30)), SamplingOptions(
            temperature=t, max_tokens=9, ignore_eos=True, seed=s))
            for t, s in ((0.9, None), (1.2, 5), (0.0, None))]
        out = _drain(te, ids)
        assert len(set(map(tuple, out))) == 3
        ranks = te.runner.last_results("decode")
        assert len(ranks) == 2
        ids0, lps0, _ = ranks[0]
        ids1, lps1, _ = ranks[1]
        assert torch.equal(ids0, ids1) and torch.equal(lps0, lps1)
        prefill = te.runner.last_results("prefill")
        assert torch.equal(prefill[0][0], prefill[1][0])
    finally:
        te.close()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)


def test_killed_worker_makes_the_engine_raise():
    """A worker killed between steps: the engine's next call raises a
    WorkerError naming its rank within the timeout, never hangs."""
    _, _, _, np_params = _pair("debug-tiny", 9)
    te = _port_engine(np_params, tensor_parallel_size=2, **_TINY)
    try:
        te.add_request(list(range(10, 20)), SamplingOptions(
            temperature=0.0, max_tokens=20, ignore_eos=True))
        te.step()
        worker = te.runner.workers[0]
        worker.kill()
        worker.join(10)
        t0 = time.monotonic()
        with pytest.raises(tworkers.WorkerError, match="rank 1"):
            while te.has_work:
                te.step()
        assert time.monotonic() - t0 < 30
    finally:
        te.close()


def test_server_answers_completions_at_tp2():
    """The OpenAI server over a tp = 2 engine answers a completion and
    /load, and the pooling route runs on every rank."""
    from aiohttp.test_utils import TestClient, TestServer
    _, _, _, np_params = _pair("debug-tiny", 10)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                               dtype=torch.float32)
    engine = AsyncLLMEngine(tec.EngineConfig(
        device="cpu", tensor_parallel_size=2, **_TINY),
        params=params_from_jax(np_params, tcfg, device="cpu"))

    async def go():
        client = TestClient(TestServer(build_app(engine, api_key="")))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json={
                "model": "debug-tiny", "prompt": "tensor parallel probe",
                "max_tokens": 6, "temperature": 0.0})
            body = await r.json()
            assert r.status == 200, body
            assert body["usage"]["completion_tokens"] == 6
            r = await client.post("/v1/embeddings", json={
                "model": "debug-tiny", "input": "a probe"})
            assert r.status == 200
            assert len((await r.json())["data"][0]["embedding"]) == 128
            r = await client.get("/load")
            assert r.status == 200
        finally:
            await client.close()
    try:
        asyncio.run(go())
    finally:
        engine.stop()
        engine.engine.close()
