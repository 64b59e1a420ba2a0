"""The port's serving meshes with dp > 1 (parallel/, models/kv.py) against
the JAX package on the CPU, at the dry run's sizes (debug-tiny, f32,
max_model_len 128, 4 slots, chunks of 32; blocks of 16: a pool of 33
blocks, padded to 34 at dp = 2).

- Pools: after the same requests, each rank of a dp = 2 x tp = 2 engine
  holds JAX's per-device shard (cache_pspec: blocks over dp, heads over
  tp) of the tp = 2 engine's pool, bit for bit, int8 scales included,
  and JAX's dp = 2 x tp = 2 engine's shards to f32 rounding.
- Tokens: the dry run's 4 prompts give the JAX dp = 2 x tp = 2 engine's
  and the JAX single-device engine's greedy tokens over f32 and int8
  pools; debug-moe at dp = 2 x ep = 2 gives ep = 2's.
- Logits: ranks in threads of this process (one gloo store) run
  llama.forward; dp = 2 x tp = 2 logits equal tp = 2's and dp = 2 x
  tp = 1 equal one rank's, bit for bit, over f32 and int8 pools.
- extract_chunk / inject_chunk bytes equal the tp = 2 engine's; /load's
  KV capacity equals JAX's on the same mesh; the refusals are JAX's,
  case for case; generate() gives JAX's text.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import \
    SamplingOptions as JSamplingOptions
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops import pallas_attention
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import sharding as jsharding

from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import parse_args
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.parallel import sharding as tsharding
from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard
from production_stack_tpu_torch.weights import params_from_jax

from tests.test_torch_parallel import _threaded_world
from tests.torch_geometry import FIXED

WORKERS = "production_stack_tpu_torch.parallel.workers:"
# the dry run's serving geometry and prompts (__graft_entry__.py:127-134)
_DRY = dict(model="debug-tiny", max_model_len=128, max_num_seqs=4,
            prefill_chunk=32, prefill_buckets=(32,), decode_window=4,
            dtype="float32", kv_dtype="float32")
PROMPTS = [list(range(3 + i, 23 + i)) for i in range(4)]
PROBE = "tensor parallel probe"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(model="debug-tiny", seed=0):
    """(JAX params, numpy params) of one f32 weight set."""
    jcfg = dataclasses.replace(jconfig.get_config(model), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _jmesh(dp, tp, ep=1):
    return jmesh.build_mesh(jmesh.MeshConfig(dp=dp, sp=1, tp=tp, ep=ep),
                            jax.devices()[:dp * tp * ep])


def _port(np_params, mesh=None, **kw):
    cfg = tec.EngineConfig(device="cpu", dp_gather_attention_ok=True,
                           **dict(FIXED, **kw))
    tcfg = dataclasses.replace(tconfig.get_config(cfg.model),
                               dtype=torch.float32)
    return tengine.LLMEngine(cfg, params=params_from_jax(
        np_params, tcfg, device="cpu"), mesh=mesh)


def _jax(jparams, mesh=None, **kw):
    return jengine.LLMEngine(jec.EngineConfig(
        dp_gather_attention_ok=True, **dict(FIXED, **kw)), params=jparams,
        mesh=mesh)


def _serve(engine, opts_cls, prompts=PROMPTS):
    ids = [engine.add_request(p, opts_cls(temperature=0.0, max_tokens=8,
                                          ignore_eos=True))
           for p in prompts]
    while engine.has_work:
        engine.step()
    return [engine.seqs[i].output_tokens for i in ids]


def _device_shards(mesh, x, spec):
    """{(dp_rank, tp_rank): numpy block} of x placed with `spec` on a
    JAX (dp, tp) mesh."""
    from jax.sharding import NamedSharding
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    return _shards_of(mesh, arr)


def _shards_of(mesh, arr):
    devs = np.asarray(mesh.devices).reshape(-1)
    tp = mesh.shape["tp"]
    out = {}
    for sh in arr.addressable_shards:
        rank = int(np.flatnonzero(devs == sh.device)[0])
        out[(rank // tp, rank % tp)] = np.asarray(sh.data)
    return out


def _whole(pools, dp, tp, name):
    """The whole pool [L, N, Hkv, Bs, D] of a tp-only engine's rank pools
    (heads concatenated over tp), padded with zero blocks to a multiple
    of dp."""
    t = np.concatenate([p[name].numpy() for p in pools], axis=2)
    n = tsharding.padded_blocks(t.shape[1], dp)
    pad = np.zeros((t.shape[0], n - t.shape[1]) + t.shape[2:], t.dtype)
    return np.concatenate([t, pad], axis=1)


@pytest.fixture(scope="module", params=["float32", "int8"])
def dp_runs(request):
    """The dry run's prompts through the JAX single-device and dp = 2 x
    tp = 2 engines and the port's tp = 2 and dp = 2 x tp = 2 engines on
    one weight set: tokens, /load before serving, the ports' rank pools
    after serving, then a chunk injected into slot 0 (its table over
    blocks 4 and 5, one on each dp rank) and extracted again."""
    kv = request.param
    jparams, np_params = _params(seed=2)
    cfg = dict(_DRY, kv_dtype=kv, kv_block_size=16)
    out = {"kv": kv}
    j1 = _jax(jparams, **cfg)
    out["jax"] = _serve(j1, JSamplingOptions)
    out["jax_generate"] = j1.generate(PROBE, JSamplingOptions(
        temperature=0.0, max_tokens=8))
    jm = _jmesh(2, 2)
    je = _jax(jparams, mesh=jm, **cfg)
    out["jax_load"] = je.load_report()
    out["jax_dp"] = _serve(je, JSamplingOptions)
    out["jax_mesh"] = jm
    out["jax_pool"] = {name: getattr(je.runner.cache, name)
                       for name in ("k", "v", "ks", "vs")
                       if getattr(je.runner.cache, name, None) is not None}
    g = torch.Generator().manual_seed(0)
    chunk = (torch.randn((2, 24, 2, 32), generator=g),
             torch.randn((2, 24, 2, 32), generator=g))
    for name, mesh in (("tp2", MeshConfig(tp=2)),
                       ("dp2tp2", MeshConfig(dp=2, tp=2))):
        te = _port(np_params, mesh=mesh, **cfg)
        try:
            out[name + "_load"] = te.load_report()
            out[name] = _serve(te, SamplingOptions)
            out[name + "_pools"] = te.runner.map_ranks(WORKERS +
                                                       "pool_tensors")
            out[name + "_generate"] = te.generate(PROBE, SamplingOptions(
                temperature=0.0, max_tokens=8))
            tables = np.zeros_like(te._tables)
            tables[0, :2] = (4, 5)
            te.runner.set_block_tables(tables)
            te.runner.inject_chunk(0, 0, *chunk)
            out[name + "_extract"] = te.runner.extract_chunk(0, 0, 24)
            out[name + "_calls"] = dict(te.runner.mesh.calls)
        finally:
            te.close()
    out["chunk"] = chunk
    return out


def test_dp_engine_tokens_equal_jax(dp_runs):
    """Greedy tokens of the port's dp = 2 x tp = 2 engine equal the JAX
    dp = 2 x tp = 2 engine's and the JAX single-device engine's (the
    dry run's parity, over f32 and int8 pools), and the port's tp = 2
    engine's; the layers' blocks were assembled over dp."""
    assert dp_runs["jax_dp"] == dp_runs["jax"]
    assert dp_runs["dp2tp2"] == dp_runs["jax"]
    assert dp_runs["tp2"] == dp_runs["jax"]
    assert dp_runs["dp2tp2_calls"]["dp.assemble"] > 0
    assert "dp.assemble" not in dp_runs["tp2_calls"]


def test_dp_rank_pools_are_jax_shards(dp_runs):
    """Each rank's blocks (the scratch block aside) are JAX's per-device
    shard, under cache_pspec / cache_scale_pspec on the dp = 2 x tp = 2
    mesh, of the tp = 2 engine's pool after the same requests, bit for
    bit; and JAX's dp = 2 x tp = 2 engine's own shards to f32 rounding
    (the int8 payload dequantized: JAX's jitted writes round a few ties
    the other way)."""
    jm = dp_runs["jax_mesh"]
    pools = dp_runs["dp2tp2_pools"]
    assert len(pools) == 4
    names = ("k", "v", "ks", "vs") if dp_runs["kv"] == "int8" else ("k", "v")
    for name in names:
        whole = _whole(dp_runs["tp2_pools"], 2, 2, name)
        spec = (jsharding.cache_pspec() if name in ("k", "v")
                else jsharding.cache_scale_pspec())
        want = _device_shards(jm, whole, spec)
        jax_own = _shards_of(jm, dp_runs["jax_pool"][name])
        for rank, pool in enumerate(pools):
            s = Shard.of(MeshConfig(dp=2, tp=2), rank)
            got = pool[name].numpy()
            assert got.shape[1] == whole.shape[1] // 2 + 1   # + scratch
            np.testing.assert_array_equal(got[:, :-1],
                                          want[(s.dp_rank, s.tp_rank)],
                                          err_msg=name)
            if dp_runs["kv"] == "float32":
                # trash block 0 (dp rank 0's first) aside: parked rows
                # write there what each engine's parked attention gives
                lo = 1 if s.dp_rank == 0 else 0
                np.testing.assert_allclose(
                    got[:, lo:-1], jax_own[(s.dp_rank, s.tp_rank)][:, lo:],
                    rtol=0, atol=1e-5, err_msg=name)
    if dp_runs["kv"] == "int8":
        for rank, pool in enumerate(pools):
            s = Shard.of(MeshConfig(dp=2, tp=2), rank)
            jk = _shards_of(jm, dp_runs["jax_pool"]["k"])[(s.dp_rank,
                                                           s.tp_rank)]
            jks = _shards_of(jm, dp_runs["jax_pool"]["ks"])[(s.dp_rank,
                                                             s.tp_rank)]
            lo = 1 if s.dp_rank == 0 else 0
            got = (pool["k"].numpy()[:, lo:-1]
                   * pool["ks"].numpy()[:, lo:-1, ..., None])
            np.testing.assert_allclose(
                got, (jk * jks[..., None])[:, lo:], rtol=0, atol=0.02)


def test_dp_load_capacity_equals_jax(dp_runs):
    """N = 33 blocks does not split over dp = 2: both engines pad it to
    34 and /load reports the same free blocks and pool census."""
    jl, tl = dp_runs["jax_load"], dp_runs["dp2tp2_load"]
    assert tl["free_kv_blocks"] == jl["free_kv_blocks"] == 33
    assert tl["kv_pool"] == jl["kv_pool"]
    assert dp_runs["tp2_load"]["free_kv_blocks"] == 32


def test_dp_extract_inject_bytes_equal_tp2(dp_runs):
    """A chunk injected into blocks on both dp ranks extracts as the
    tp = 2 engine's does, byte for byte (f32: the chunk itself)."""
    for part in range(2):
        got = dp_runs["dp2tp2_extract"][part]
        assert torch.equal(got, dp_runs["tp2_extract"][part])
        if dp_runs["kv"] == "float32":
            assert torch.equal(got, dp_runs["chunk"][part])


def test_generate_equals_jax_text(dp_runs):
    """LLMEngine.generate (JAX engine.py:2005-2013) on the dp = 2 x tp = 2
    and tp = 2 engines gives the JAX single-device engine's text."""
    assert dp_runs["jax_generate"]
    assert dp_runs["dp2tp2_generate"] == dp_runs["jax_generate"]
    assert dp_runs["tp2_generate"] == dp_runs["jax_generate"]


@pytest.mark.parametrize("dp,ep,tp", [(2, 1, 2), (2, 2, 1), (2, 2, 2),
                                      (4, 1, 2), (2, 1, 1)])
def test_shard_coordinates_are_jax_device_positions(dp, ep, tp):
    """Rank r of a dp x ep x tp serving mesh sits where device r sits in
    JAX's device array (pp, dp, sp, ep, tp); the world axis is one dp
    replica's ep x tp ranks."""
    cfg = MeshConfig(dp=dp, ep=ep, tp=tp)
    devs = np.arange(cfg.size).reshape(1, dp, 1, ep, tp)
    for r in range(cfg.size):
        s = Shard.of(cfg, r)
        assert devs[0, s.dp_rank, 0, s.ep_rank, s.tp_rank] == r == s.rank
        assert s.axis("world") == (s.ep_rank * tp + s.tp_rank, ep * tp)
    with pytest.raises(ValueError, match="dp, ep and tp"):
        Shard.of(MeshConfig(dp=dp, sp=2, tp=tp), 0)


def test_assemble_is_bit_exact():
    """ServingMesh.assemble over dp: each element from its one owner,
    bit for bit (-0.0 and NaN payloads kept), bf16 / f32 / int8; the
    calls are counted by axis."""
    base = torch.tensor([[-0.0, 1.5, float("nan"), -3.25]])

    def rank(mesh):
        out = []
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            full = (base.nan_to_num(7.0) if dtype == torch.int8
                    else base).to(dtype)
            mine = torch.zeros_like(full)
            cols = slice(0, 2) if mesh.shard.dp_rank == 0 else slice(2, 4)
            mine[:, cols] = full[:, cols]
            out.append((mesh.assemble(mine, "dp"), full))
        return out, dict(mesh.calls)

    for got, calls in _threaded_world(MeshConfig(dp=2, tp=2), rank):
        assert calls == {"dp.assemble": 3}
        for a, want in got:
            assert a.dtype == want.dtype
            assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                               else a.view(torch.int16 if a.element_size()
                                           == 2 else torch.int32),
                               want.view(torch.uint8)
                               if want.element_size() == 1
                               else want.view(torch.int16
                                              if want.element_size() == 2
                                              else torch.int32))


def _steps(cfg, B, rng):
    """A ragged prefill chunk of 12, a decode step (T = 1), a verify-like
    window (T = 4) and a second chunk of 12 (T > 8: the prefill kernel's
    path), each (tokens, positions, valid, kv_len)."""
    V = cfg.vocab_size
    steps = []
    toks = rng.integers(0, V, (B, 12)).astype(np.int32)
    valid = np.arange(12)[None, :] < np.array([12, 7, 3])[:B, None]
    steps.append((toks, np.broadcast_to(np.arange(12, dtype=np.int32),
                                        (B, 12)).copy(), valid, 12))
    start = 12
    for T in (1, 4, 12):
        pos = (start + np.arange(T, dtype=np.int32))[None].repeat(B, 0)
        steps.append((rng.integers(0, V, (B, T)).astype(np.int32), pos,
                      np.ones((B, T), bool), start + T))
        start += T
    return steps


@pytest.mark.parametrize("dp,tp,kv", [(2, 2, "float32"), (2, 1, "float32"),
                                      (2, 2, "int8"), (2, 1, "int8")])
def test_dp_logits_bit_equal_to_the_mesh_without_dp(dp, tp, kv):
    """Ranks in threads run llama.forward over dp-split pools (the pool's
    31 blocks padded to 32, tables a permutation over both dp ranks):
    every rank's logits equal the tp-only world's (tp = 1: one whole
    model's), bit for bit, at T = 12, 1, 4 and 12."""
    cfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                              dtype=torch.float32)
    full = tllama.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    rng = np.random.default_rng(5)
    B, Bs, N = 3, 8, 31
    MB = -(-40 // Bs)
    tables = torch.from_numpy((rng.permutation(N - 1)[:B * MB] + 1)
                              .reshape(B, MB).astype(np.int32))
    steps = _steps(cfg, B, rng)
    dtype = torch.int8 if kv == "int8" else torch.float32

    def run(params, cache):
        out = []
        for tok, pos, val, kv_len in steps:
            logits, _ = tllama.forward(
                params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
                cache, block_tables=tables, kv_len=kv_len,
                token_valid=torch.from_numpy(val))
            out.append(logits)
        return out

    def rank(mesh):
        s = mesh.shard
        params = tsharding.shard_params(full, s)
        params.mesh = mesh
        cache = tkv.make_cache(cfg.num_layers,
                               tsharding.padded_blocks(N, s.dp), Bs,
                               cfg.num_kv_heads // s.tp, cfg.head_dim_,
                               dtype=dtype, device="cpu", dp=s.dp,
                               dp_rank=s.dp_rank)
        return run(params, cache)

    if tp > 1:
        want = _threaded_world(MeshConfig(tp=tp), rank)[0]
    else:
        want = run(full, tkv.make_cache(cfg.num_layers, N, Bs,
                                        cfg.num_kv_heads, cfg.head_dim_,
                                        dtype=dtype, device="cpu"))
    got = _threaded_world(MeshConfig(dp=dp, tp=tp), rank)
    for r, logits in enumerate(got):
        for i, (g, w) in enumerate(zip(logits, want)):
            assert torch.equal(g, w), (r, i)


def test_moe_dp2_ep2_equals_ep2():
    """debug-moe at capacity factor 0.5 (prefill chunks drop on the
    dispatch path, decode is exact): dp = 2 x ep = 2 gives ep = 2's
    tokens; each replica combines its own experts' partials only."""
    _, np_params = _params("debug-moe", seed=5)
    cfg = dict(_DRY, model="debug-moe", moe_capacity_factor=0.5,
               max_num_seqs=3)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 70, 12)]
    runs = {}
    for name, mesh in (("ep2", MeshConfig(ep=2)),
                       ("dp2ep2", MeshConfig(dp=2, ep=2))):
        te = _port(np_params, mesh=mesh, **cfg)
        try:
            runs[name] = _serve(te, SamplingOptions, prompts)
            runs[name + "_calls"] = dict(te.runner.mesh.calls)
        finally:
            te.close()
    assert runs["dp2ep2"] == runs["ep2"]
    assert runs["dp2ep2_calls"]["world.all_reduce"] \
        == runs["ep2_calls"]["world.all_reduce"] > 0
    assert runs["dp2ep2_calls"]["dp.assemble"] > 0


_REFUSAL_CFG = dict(model="debug-tiny", max_model_len=128, max_num_seqs=4,
                    prefill_chunk=32, prefill_buckets=(32,))


@pytest.mark.parametrize("dp,tp,flag,outcome", [
    (2, 2, False, "refused"),
    (2, 2, True, "warned"),
    (1, 2, False, "served"),
])
def test_dp_refusals_match_jax(dp, tp, flag, outcome, monkeypatch):
    """tests/test_parallel.py:122-150's grid: where the kernels would run
    (JAX under set_flash_enabled(True); the port's check_mesh on a
    "cuda" device, no card needed), a dp > 1 mesh refuses naming the
    gathered-view path, with the flag it warns once, and a tp-only mesh
    is untouched. The message opens with JAX's, mesh shape and all."""
    jm = _jmesh(dp, tp)
    tcfg = tconfig.get_config("debug-tiny")
    status = {}
    pallas_attention.set_flash_enabled(True)
    try:
        try:
            jengine.LLMEngine(jec.EngineConfig(
                dp_gather_attention_ok=flag, **_REFUSAL_CFG), mesh=jm)
            status["jax"] = "ok"
        except ValueError as e:
            status["jax"] = "refused"
            jax_msg = str(e)
    finally:
        pallas_attention.set_flash_enabled(None)
    warnings = []
    monkeypatch.setattr(tsharding.logger, "warning",
                        lambda msg, *a: warnings.append(msg % a))
    try:
        tsharding.check_mesh(tcfg, tp, 1, dp, torch.device("cuda"), flag)
        status["port"] = "ok"
    except ValueError as e:
        status["port"] = "refused"
        port_msg = str(e)
    assert status["port"] == status["jax"] \
        == ("refused" if outcome == "refused" else "ok")
    assert len(warnings) == (outcome == "warned")
    assert all(w.startswith("dp_gather_attention_ok=True: ")
               for w in warnings)
    if outcome == "refused":
        assert "gathered-view" in port_msg and "gathered-view" in jax_msg
        head = "shards the KV pool's block axis"
        assert port_msg.split(head)[0] == jax_msg.split(head)[0]
        assert port_msg.endswith(jax_msg.split(".")[-2] + ".")


def test_dp_mesh_on_the_cpu_warns_and_the_flag_parses(monkeypatch):
    """On the CPU, where the plain versions run, a dp mesh only warns (as
    JAX warns where its kernel is off); --dp-gather-attention-ok parses
    as the JAX server's and stays off by default."""
    from production_stack_tpu.engine.server import parse_args as jparse
    warnings = []
    monkeypatch.setattr(tsharding.logger, "warning",
                        lambda msg, *a: warnings.append(msg % a))
    tsharding.check_mesh(tconfig.get_config("debug-tiny"), 2, 1, 2,
                         torch.device("cpu"), False)
    assert len(warnings) == 1 and "gathered-view" in warnings[0]
    for parse in (parse_args, jparse):
        assert parse([]).dp_gather_attention_ok is False
        assert parse(["--dp-gather-attention-ok"]).dp_gather_attention_ok
