"""The PyTorch port's multi-LoRA against the JAX package's on the CPU:
``lora.apply``, the .npz format both ways, the adapter checks, the
forward with stacked adapters selected per row, and engines serving
adapters as model ids (mixed batches, runtime load and evict, salted
prefix keys, speculation and int8 weights) — the setups of
tests/test_lora.py run through both packages.

Weights and adapters are drawn once by the JAX package and carried
across (weights.params_from_jax, weights.adapter_from_jax, or the .npz
files the JAX package writes), never re-drawn. Tolerances:
- ``apply``: atol 1e-6 (float32; one delta of two small products);
- float32 logits: 1e-4, as tests/test_torch_model.py holds the base
  forward;
- greedy tokens: exact;
- the .npz format: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import lora as jlora
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import lora as tlora
from production_stack_tpu_torch.weights import (adapter_from_jax,
                                                cache_from_jax,
                                                params_from_jax)

from tests.torch_geometry import FIXED

ALL7 = ("q", "k", "v", "o", "gate", "up", "down")
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(model="debug-tiny", dtype="float32"):
    return (dataclasses.replace(jconfig.get_config(model),
                                dtype=_DT[dtype][0]),
            dataclasses.replace(tconfig.get_config(model),
                                dtype=_DT[dtype][1]))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


# ------------------------------------------------------------ lora.apply

@pytest.mark.parametrize("T", [1, 6])
def test_apply_matches_jax(T):
    """One layer's stack of 3 adapters (row 0 zero) over ids [0, 2, 1, 2,
    0]: the port's gathered rows and in-place product equal JAX's einsums
    to 1e-6; the base rows are left bit for bit."""
    rng = np.random.default_rng(T)
    N, B, d_in, d_out, r = 3, 5, 24, 40, 4
    a = (rng.standard_normal((N + 1, d_in, r)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((N + 1, r, d_out)) * 0.05).astype(np.float32)
    a[0] = b[0] = 0
    ids = np.array([0, 2, 1, 2, 0], np.int32)
    x = rng.standard_normal((B, T, d_in)).astype(np.float32)
    base = rng.standard_normal((B, T, d_out)).astype(np.float32)
    want = np.asarray(jlora.apply(
        jnp.asarray(x), jnp.asarray(base),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(ids), 2.0))
    rows = tlora.gather_rows(
        {"p": (torch.from_numpy(a)[None], torch.from_numpy(b)[None])},
        torch.from_numpy(ids))
    out = torch.from_numpy(base.copy())
    got = tlora.apply(torch.from_numpy(x), out, rows["p"][0][0],
                      rows["p"][1][0], 2.0)
    assert got is out
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[ids == 0], base[ids == 0])
    assert np.abs(got.numpy() - base).max() > 1e-3


# ---------------------------------------------------------- .npz format

@pytest.mark.parametrize("model,targets", [("debug-tiny", ALL7),
                                           ("debug-gemma2", ("q", "v"))])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_round_trip_bit_equal(tmp_path, model, targets, direction):
    """bf16 adapters written by one package load bit for bit in the
    other (float32 on disk holds bf16 exactly)."""
    jcfg, tcfg = _cfgs(model, "bfloat16")
    lcfg_j = jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    lcfg_t = tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    path = str(tmp_path / "ad.npz")
    if direction == "jax_to_port":
        src = jlora.random_adapter(jcfg, lcfg_j, jax.random.PRNGKey(3))
        jlora.save_adapter_npz(src, path)
        got = tlora.load_adapter_npz(tcfg, lcfg_t, path, device="cpu")
        want = _np(src)
    else:
        src = tlora.random_adapter(tcfg, lcfg_t,
                                   torch.Generator().manual_seed(3),
                                   device="cpu")
        tlora.save_adapter_npz(src, path)
        got = jlora.load_adapter_npz(jcfg, lcfg_j, path)
        want = {n: {k: v.float().numpy() for k, v in ab.items()}
                for n, ab in src.items()}
    assert set(got) == set(targets)
    for name in targets:
        for k in ("a", "b"):
            g = got[name][k]
            assert g.dtype == (torch.bfloat16 if direction == "jax_to_port"
                               else jnp.bfloat16)
            g = (g.float().numpy() if direction == "jax_to_port"
                 else np.asarray(g, np.float32))
            np.testing.assert_array_equal(g, want[name][k])


def _bad_npz(tmp_path, kind):
    path = str(tmp_path / f"{kind}.npz")
    if kind == "shapes":
        np.savez(path, **{"q.a": np.zeros((1, 2, 3)),
                          "q.b": np.zeros((3, 2)),
                          "v.a": np.zeros((1, 2, 3)),
                          "v.b": np.zeros((3, 2))})
    else:
        np.savez(path, **{"q.a": np.zeros((2, 64, 8))})
    return path


@pytest.mark.parametrize("kind,model,targets", [
    ("shapes", "debug-tiny", ("q", "v")),
    ("missing", "debug-tiny", ("q", "v")),
    ("unknown_target", "debug-tiny", ("q", "x")),
    ("moe_mlp_target", "debug-moe", ("q", "gate")),
])
def test_bad_adapters_raise_as_jax(tmp_path, kind, model, targets):
    """Wrong shapes, a missing factor, an unknown target and an MLP
    target on an MoE model raise ValueError with JAX's message; an
    engine given the bad shapes raises at start, as the JAX engine
    does (test_bad_adapter_shapes_rejected)."""
    jcfg, tcfg = _cfgs(model)
    path = _bad_npz(tmp_path, kind)
    with pytest.raises(ValueError) as je:
        jlora.load_adapter_npz(jcfg, jlora.LoRAConfig(targets=targets),
                               path)
    with pytest.raises(ValueError) as te:
        tlora.load_adapter_npz(tcfg, tlora.LoRAConfig(targets=targets),
                               path, device="cpu")
    assert str(te.value) == str(je.value)
    if kind == "shapes":
        with pytest.raises(ValueError, match="adapter"):
            tengine.LLMEngine(tec.EngineConfig(
                model="debug-tiny", device="cpu", max_model_len=64,
                max_num_seqs=2, lora_adapters={"bad": path}))


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("model,targets", [("debug-tiny", ALL7),
                                           ("debug-gemma2", ("q", "v"))])
def test_forward_with_stacked_adapters_matches_jax(model, targets):
    """Two adapters carried across from JAX, rows selecting [0, 1, 2, 1]:
    a ragged prefill chunk, then decode steps. The stacks are equal bit
    for bit, the logits to 1e-4, and the adapters move them."""
    jcfg, tcfg = _cfgs(model)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    jl = jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    jads = [jlora.random_adapter(jcfg, jl, jax.random.PRNGKey(s))
            for s in (11, 22)]
    jstack = jlora.stack_adapters(jcfg, jl, jads)
    tstack = tlora.stack_adapters(
        tcfg, tl, [adapter_from_jax(_np(a), tcfg, device="cpu")
                   for a in jads], device="cpu")
    for name in targets:
        for k in ("a", "b"):
            np.testing.assert_array_equal(tstack[name][k].numpy(),
                                          np.asarray(jstack[name][k]))
    ids = np.array([0, 1, 2, 1], np.int32)
    rows = tlora.gather_rows(tlora.layer_slice(tstack),
                             torch.from_numpy(ids))
    jlayers = jlora.layer_slice(jstack)
    rng = np.random.default_rng(4)
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    B, Bs, MB, N = 4, 16, 6, 26
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.float32)
    tcache, ttables = cache_from_jax(np.asarray(jcache.k),
                                     np.asarray(jcache.v), tables,
                                     dtype=torch.float32, device="cpu")

    jforward = jax.jit(
        lambda p, t, pos, c, tab, lp, a, v, kv_len: jllama.forward(
            p, jcfg, t, pos, c, block_tables=tab, kv_len=kv_len,
            lora_params=lp, adapter_ids=a, lora_scaling=jl.scaling,
            token_valid=v), static_argnames="kv_len")

    def check(tokens, positions, valid, kv_len):
        nonlocal jcache
        want, jcache = jforward(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), jcache,
            jnp.asarray(tables), jlayers, jnp.asarray(ids),
            jnp.asarray(valid), kv_len=kv_len)
        args = (tparams, tcfg, torch.from_numpy(tokens),
                torch.from_numpy(positions))
        got, _ = tllama.forward(
            *args, tcache, block_tables=ttables, kv_len=kv_len,
            token_valid=torch.from_numpy(valid), lora_rows=rows,
            lora_scaling=tl.scaling)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy()[valid], want[valid],
                                   rtol=0, atol=1e-4)
        return got

    T = 12
    lens = np.array([12, 7, 10, 12], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32),
                                (B, T)).copy()
    valid = np.arange(T)[None, :] < lens[:, None]
    got = check(tokens, positions, valid, kv_len=16)
    # rows 1 and 3 share a prompt slot's tokens but not row 0's adapter
    assert not torch.allclose(got[1, :7], got[0, :7], atol=1e-3)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = (lens + step)[:, None].astype(np.int32)
        check(tok, pos, np.ones((B, 1), bool), kv_len=32)


# -------------------------------------------------------------- engines

_ENG = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
            max_model_len=128, max_num_seqs=4, prefill_chunk=32,
            prefill_buckets=(32,), decode_window=4, kv_block_size=8,
            lora_rank=4, lora_alpha=8.0, lora_targets=ALL7)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jllama.init_params(jcfg, jax.random.PRNGKey(5))


def _tparams(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           _cfgs()[1], device="cpu")


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Three .npz adapters written by the JAX package (all seven
    targets, rank 4), by name."""
    d = tmp_path_factory.mktemp("lora")
    jcfg, _ = _cfgs()
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, targets=ALL7)
    out = {}
    for name, seed in (("ad-one", 11), ("ad-two", 22), ("ad-rt", 33)):
        path = str(d / f"{name}.npz")
        jlora.save_adapter_npz(
            jlora.random_adapter(jcfg, lcfg, jax.random.PRNGKey(seed)), path)
        out[name] = path
    return out


def _pair(jparams, adapters, names=("ad-one", "ad-two"), **kw):
    cfg = dict(_ENG, lora_adapters={n: adapters[n] for n in names}, **kw)
    te = tengine.LLMEngine(tec.EngineConfig(**cfg, device="cpu",
                                            **FIXED),
                           params=_tparams(jparams))
    if kw.get("quantization"):
        # the JAX engine quantizes donated params: give it its own copy
        jparams = jax.tree_util.tree_map(jnp.copy, jparams)
    return (jengine.LLMEngine(jec.EngineConfig(**cfg, window_adapt=False,
                                               pipeline_depth=1),
                              params=jparams), te)


@pytest.fixture(scope="module")
def pair(weights, adapters):
    return _pair(weights, adapters)


def _run(engine, opts_cls, jobs, max_tokens=8):
    """Greedy tokens of (prompt, model) jobs submitted together."""
    ids = [engine.add_request(list(p), opts_cls(temperature=0.0,
                                                max_tokens=max_tokens,
                                                ignore_eos=True),
                              model=m)
           for p, m in jobs]
    while engine.has_work:
        engine.step()
    return [list(engine.seqs[i].output_tokens) for i in ids]


_PROMPT = list(range(7, 27))
_MIXED = [(_PROMPT, None), (_PROMPT, "ad-one"), (_PROMPT, "ad-two"),
          (list(range(40, 75)), "ad-one")]


def test_served_models_and_resolve_equal_jax(pair):
    je, te = pair
    assert te.served_models == je.served_models == [
        "debug-tiny", "ad-one", "ad-two"]
    for name in (None, "debug-tiny", "ad-one", "ad-two"):
        assert te.resolve_model(name) == je.resolve_model(name)
    with pytest.raises(ValueError, match="unknown model") as te_err:
        te.resolve_model("nope")
    with pytest.raises(ValueError, match="unknown model") as je_err:
        je.resolve_model("nope")
    assert str(te_err.value) == str(je_err.value)


def test_mixed_batch_tokens_equal_jax(pair):
    """Base, both adapters and a second ad-one row in one batch: the
    greedy tokens per row equal the JAX engine's, and the three model
    ids give three distinct streams."""
    je, te = pair
    want = _run(je, JSamplingOptions, _MIXED)
    got = _run(te, SamplingOptions, _MIXED)
    assert got == want
    assert len({tuple(t) for t in got[:3]}) == 3


def test_mixed_batch_equals_solo(pair):
    """Each row of the mixed batch equals its request served alone:
    per-row selection does not leak across slots."""
    _, te = pair
    mixed = _run(te, SamplingOptions, _MIXED)
    solo = [_run(te, SamplingOptions, [job])[0] for job in _MIXED]
    assert mixed == solo


def test_runtime_adapter_load_and_evict_equal_jax(weights, adapters):
    """JAX's test_runtime_adapter_load_and_evict on both engines: a load
    serves a new model id whose tokens equal JAX's, a reload and the
    base name answer False, evict tombstones the row (the name is
    unknown, a second evict raises KeyError), ids are append-only, and
    the counters and the tpu:engine_adapter_* series agree."""
    from prometheus_client.parser import text_string_to_metric_families
    engines = _pair(weights, adapters, names=("ad-one",))
    for eng, opts in zip(engines, (JSamplingOptions, SamplingOptions)):
        base_models = list(eng.served_models)
        assert eng.load_adapter("ad-rt", adapters["ad-rt"]) is True
        assert eng.load_adapter("ad-rt", adapters["ad-rt"]) is False
        assert eng.load_adapter("debug-tiny", adapters["ad-rt"]) is False
        assert eng.served_models == base_models + ["ad-rt"]
        assert eng.lora_ids["ad-rt"] == 2
    (je, te) = engines
    jobs = [(_PROMPT, "ad-rt"), (_PROMPT, None)]
    assert _run(te, SamplingOptions, jobs) == _run(je, JSamplingOptions,
                                                   jobs)
    for eng in engines:
        eng.evict_adapter("ad-rt")
        with pytest.raises(ValueError, match="unknown model"):
            eng.resolve_model("ad-rt")
        with pytest.raises(KeyError):
            eng.evict_adapter("ad-rt")
        assert eng.load_adapter("ad-rt2", adapters["ad-two"]) is True
        assert eng.lora_ids["ad-rt2"] == 3
        assert (eng.adapter_loads, eng.adapter_evictions) == (2, 1)
    series = ("tpu:engine_adapter_loads_total",
              "tpu:engine_adapter_evictions_total",
              "tpu:engine_adapters_loaded")
    got = {s.name: s.value for f in text_string_to_metric_families(
        te.render_metrics().decode()) for s in f.samples
        if s.name in series}
    assert got == dict(zip(series, (2.0, 1.0, 2.0)))
    assert te.load_report()["models"] == je.served_models == [
        "debug-tiny", "ad-one", "ad-rt2"]
    jobs = [(_PROMPT, "ad-rt2"), (_PROMPT, "ad-one")]
    assert _run(te, SamplingOptions, jobs) == _run(je, JSamplingOptions,
                                                   jobs)


def test_prefix_keys_salted_and_hits_equal_jax(weights, adapters):
    """The salt is the adapter's name, the keys equal JAX's, and with
    prefix caching an adapter request attaches no base block: a base
    request, the same prompt on ad-one, then base again and ad-one
    again — hits and misses equal the JAX engine's, and so do the
    tokens."""
    je, te = _pair(weights, adapters, enable_prefix_caching=True)
    prompt = list(range(100, 141))
    assert te._adapter_salt(0) == je._adapter_salt(0) == ""
    assert te._adapter_salt(1) == je._adapter_salt(1) == "lora:ad-one"
    for salt in ("", "lora:ad-one"):
        assert te.block_mgr.prefix_keys(prompt, salt=salt) == \
            je.block_mgr.prefix_keys(prompt, salt=salt)
    assert te.block_mgr.prefix_keys(prompt) != te.block_mgr.prefix_keys(
        prompt, salt="lora:ad-one")
    stats = []
    for eng, opts in ((je, JSamplingOptions), (te, SamplingOptions)):
        toks, hits = [], []
        for model in (None, "ad-one", None, "ad-one"):
            toks += _run(eng, opts, [(prompt, model)])
            hits.append((eng.block_mgr.hits, eng.block_mgr.misses))
        stats.append((toks, hits))
    assert stats[1] == stats[0]
    hits = stats[1][1]
    # the adapter's first request hits nothing the base request left
    assert hits[1][0] == hits[0][0] and hits[2][0] > hits[1][0]
    assert stats[1][0][1] == stats[1][0][3] != stats[1][0][0]


def test_speculation_with_adapter_rows_equals_jax(weights, adapters):
    """Spec 3 over a batch of base and adapter rows on a repetitive
    prompt: tokens equal the JAX engine's (one window in flight on both
    sides) and the port's own speculation-free tokens."""
    rep = [256] + list(range(30, 42)) * 4
    jobs = [(rep, None), (rep, "ad-one"), (rep, "ad-two"),
            (list(range(60, 90)), "ad-one")]
    je, te = _pair(weights, adapters, speculative_ngram_tokens=3)
    got = _run(te, SamplingOptions, jobs, max_tokens=16)
    assert got == _run(je, JSamplingOptions, jobs, max_tokens=16)
    plain = tengine.LLMEngine(tec.EngineConfig(
        **_ENG, lora_adapters={n: adapters[n] for n in ("ad-one", "ad-two")},
        device="cpu"), params=_tparams(weights))
    assert got == _run(plain, SamplingOptions, jobs, max_tokens=16)


def test_int8_weights_with_adapters_equal_jax(weights, adapters):
    """Weight-only int8 with adapters in f32: each engine quantizes the
    same weights itself; greedy tokens per model id equal the JAX int8
    engine's."""
    je, te = _pair(weights, adapters, quantization="int8")
    got = _run(te, SamplingOptions, _MIXED)
    assert got == _run(je, JSamplingOptions, _MIXED)
    assert len({tuple(t) for t in got[:3]}) == 3


def test_runner_gathers_rows_once_per_upload(weights, adapters):
    """The runner gathers the rows' factors once per sampling upload (a
    composition change) and per new stack, not per window: the same
    uploaded ids reuse the gathered rows, a batch of base rows only
    gathers nothing (its products run without the adapters' launches),
    and a runtime load regathers."""
    import dataclasses as dc

    from production_stack_tpu_torch.engine.sampler import SamplingParams
    _, te = _pair(weights, adapters)
    runner = te.runner

    def sp(ids):
        return dc.replace(SamplingParams.filled(4, device="cpu"),
                          adapter=torch.tensor(ids, dtype=torch.int32))

    base = sp([0, 0, 0, 0])
    assert runner._lora_rows(base, 4) is None
    mixed = sp([0, 2, 1, 0])
    rows = runner._lora_rows(mixed, 4)
    assert set(rows) == set(ALL7)
    a, b = rows["q"]
    assert a.shape[:2] == (te.model_cfg.num_layers, 4)
    assert not a[:, 0].any() and not a[:, 3].any() and a[:, 1].any()
    assert runner._lora_rows(mixed, 4) is rows
    assert te.load_adapter("ad-rt", adapters["ad-rt"]) is True
    again = runner._lora_rows(mixed, 4)
    assert again is not rows
    assert torch.equal(again["q"][0], a)
