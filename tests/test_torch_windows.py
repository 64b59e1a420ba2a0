"""Continuous batching across decode windows in the port (batch buckets
with slot compaction, adaptive window sizing, windows dispatched ahead)
against the JAX engine on the CPU, at debug sizes and float32.

Both engines run the same requests on the same weights (drawn by the
JAX package, carried across by weights.params_from_jax). Greedy tokens
must be equal, and so must the sequence of decode windows the
efficiency ring records: (batch, steps, kv_len, live_rows, real, pad,
dead) window by window. The JAX engines are built once per
configuration and reused across runs (their executables compile once;
the JAX engine reads pipeline_depth at each step, so one engine serves
every depth); each reuse drains the windows left in flight and resets
the EOS rate, so a run starts from a fresh engine's state.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import scheduler as jscheduler
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import scheduler as tscheduler
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.scheduler import (SamplingOptions,
                                                         SeqStatus)
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

_BASE = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
             max_model_len=256, max_num_seqs=4, prefill_chunk=32,
             prefill_buckets=(32,), decode_window=4)

# the fields a window of the efficiency ring is compared on
_KEYS = ("batch", "steps", "kv_len", "live_rows", "real", "pad", "dead")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(model, seed):
    jcfg = dataclasses.replace(jconfig.get_config(model), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config(model),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    tcfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _weights("debug-tiny", 0)


class _Jax:
    """JAX engines by configuration, built once and reused."""

    def __init__(self, params):
        self.params = params
        self.engines = {}

    def get(self, **cfg):
        depth = cfg.pop("pipeline_depth", 2)
        key = tuple(sorted(cfg.items()))
        eng = self.engines.get(key)
        if eng is None:
            eng = self.engines[key] = jengine.LLMEngine(
                jec.EngineConfig(**cfg), params=self.params)
        eng.cfg.pipeline_depth = depth
        while eng._inflight:
            eng._process_window(eng._sync_inflight())
        eng._eos_rate = 0.0
        return eng


@pytest.fixture(scope="module")
def jax_engines(tiny):
    return _Jax(tiny[0])


def _port(params, **cfg):
    return tengine.LLMEngine(tec.EngineConfig(**cfg, device="cpu"),
                             params=params)


def _run(engine, opts_cls, prompts, rows, hook=None):
    """Serve the requests to the end; (each request's tokens, each
    request's finish reason, the windows recorded in this run)."""
    seen = len(engine.eff._windows)
    ids = [engine.add_request(list(p), opts_cls(**kw))
           for p, kw in zip(prompts, rows)]
    steps = 0
    while engine.has_work:
        if hook is not None:
            hook(engine, steps, ids)
        engine.step()
        steps += 1
        assert steps < 2000
    ring = list(engine.eff._windows)[seen:]
    return ([engine.seqs[i].output_tokens for i in ids],
            [engine.seqs[i].finish_reason for i in ids],
            [tuple(w[k] for k in _KEYS) for w in ring])


def _staggered(n=6):
    """tests/test_engine.py::test_pipelined_windows_match_unpipelined's
    workload: n requests on 4 slots, budgets 10 + 7i."""
    return ([list(range(5 + i, 15 + i)) for i in range(n)],
            [dict(temperature=0.0, max_tokens=10 + 7 * i, ignore_eos=True)
             for i in range(n)])


# ------------------------------------------------------------ (a) config

@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_num_seqs=6, decode_window=5),
    dict(max_num_seqs=4, decode_batch_buckets=(3, 1, 9, 3),
         decode_window_buckets=(2, 16)),
    dict(max_num_seqs=16, decode_window=3, decode_batch_buckets=(5,)),
    dict(max_model_len=4, decode_window=8),
    dict(speculative_ngram_tokens=3),
    dict(window_adapt=False, pipeline_depth=8),
])
def test_config_buckets_equal_jax(kw):
    """Bucket derivation, batch_bucket_for over every row count, the
    depth, and speculation forcing window_adapt off: the port's config
    equals the JAX config's."""
    got = tec.EngineConfig(model="debug-tiny", device="cpu", **kw)
    want = jec.EngineConfig(model="debug-tiny", **kw)
    for f in ("decode_batch_buckets", "decode_window_buckets",
              "window_adapt", "pipeline_depth", "decode_window",
              "kv_len_buckets"):
        assert getattr(got, f) == getattr(want, f), f
    for rows in range(0, got.max_num_seqs + 2):
        assert got.batch_bucket_for(rows) == want.batch_bucket_for(rows)
    if kw.get("speculative_ngram_tokens"):
        assert not got.window_adapt


@pytest.mark.parametrize("kw", [dict(pipeline_depth=0),
                                dict(pipeline_depth=9),
                                dict(decode_batch_buckets=(9, 12)),
                                dict(decode_window_buckets=(0, -1))])
def test_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as got:
        tec.EngineConfig(model="debug-tiny", device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jec.EngineConfig(model="debug-tiny", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------- (b) pipelined windows, depth

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_windows_equal_jax(tiny, jax_engines, depth):
    """The JAX package's pipelined-windows workload at depth 1, 2 and 3:
    tokens and the window sequence equal the JAX engine's; the batch
    reaches buckets 4, 2 and 1; from depth 2 on some window was
    dispatched ahead."""
    prompts, rows = _staggered()
    ahead_seen = []
    te = _port(tiny[1], **dict(_BASE, pipeline_depth=depth))
    dispatch = te._dispatch_decode

    def spy(seqs, ahead=0):
        ok = dispatch(seqs, ahead)
        ahead_seen.append(ok and ahead > 0)
        return ok

    te._dispatch_decode = spy
    got = _run(te, SamplingOptions, prompts, rows)
    want = _run(jax_engines.get(**_BASE, pipeline_depth=depth),
                JSamplingOptions, prompts, rows)
    assert got == want
    assert [len(t) for t in got[0]] == [r["max_tokens"] for r in rows]
    assert {w[0] for w in got[2]} == {1, 2, 4}
    assert any(ahead_seen) == (depth > 1)
    assert set(te.eff.recent_windows(1)[0]) == \
        set(jax_engines.get(**_BASE).eff.recent_windows(1)[0])


# ------------------------------------------------ (c) the EOS horizon

def test_stop_ids_move_the_eos_horizon_as_in_jax(tiny, jax_engines):
    """Rows that stop on a stop id (finish_reason "stop") raise the EOS
    rate, which shortens later windows: tokens, finish reasons, the
    window sequence and the final rate equal the JAX engine's."""
    prompts, rows = _staggered()
    free, _, _ = _run(_port(tiny[1], **_BASE), SamplingOptions, prompts,
                      rows)
    # each of the first four rows stops on its own 3rd..6th token
    for i in range(4):
        rows[i] = dict(rows[i], stop_token_ids=[free[i][2 + i]])
    te = _port(tiny[1], **_BASE)
    je = jax_engines.get(**_BASE)
    got = _run(te, SamplingOptions, prompts, rows)
    want = _run(je, JSamplingOptions, prompts, rows)
    assert got == want
    assert got[1][:4] == ["stop"] * 4
    assert te._eos_rate > 0
    assert te._eos_rate == pytest.approx(je._eos_rate, rel=1e-12)


# ------------------------------------------------------ (d) compaction

def test_compaction_moves_slots_and_reconciles_as_in_jax(tiny,
                                                         jax_engines):
    """tests/test_efficiency.py's compaction scenario (budgets 3, 9 and
    21 admitted together): the batch steps 4 -> 2 -> 1, the survivor is
    moved to slot 0 with its block-table row, real + pad + dead add up
    to the token-steps, and the windows equal the JAX engine's."""
    cfg = _BASE
    prompts = [list(range(20 + 3 * i, 40 + 3 * i)) for i in range(3)]
    rows = [dict(temperature=0.0, max_tokens=m, ignore_eos=True)
            for m in (3, 9, 21)]
    moved = []

    def watch(eng, step, ids):
        c = eng.seqs.get(ids[2])
        if c is not None and c.status is SeqStatus.RUNNING and \
                c.slot == 0 and not moved:
            moved.append((list(c.block_ids), eng._tables[0].copy(),
                          eng.runner._dev_tables()[0].numpy().copy()))

    te = _port(tiny[1], **cfg)
    got = _run(te, SamplingOptions, prompts, rows, hook=watch)
    want = _run(jax_engines.get(**cfg), JSamplingOptions, prompts, rows)
    assert got == want
    batches = [w[0] for w in got[2]]
    assert batches[0] == 4 and 2 in batches and batches[-1] == 1
    assert batches == sorted(batches, reverse=True)
    blocks, host, dev = moved[0]
    assert blocks and list(host[:len(blocks)]) == blocks
    assert not host[len(blocks):].any()
    np.testing.assert_array_equal(dev, host)
    d = te.eff.report()["decode"]
    assert d["real"] + d["pad"] + d["dead"] == d["token_steps_total"]
    assert d["real"] == sum(r["max_tokens"] for r in rows) - len(rows)


# --------------------------------------------------- (e) the kv probe

def test_kv_bucket_above_grid_pins_fixed_geometry(tiny):
    """A window whose attention length falls in a kv bucket above the
    smallest dispatches at (max_num_seqs, decode_window), as the JAX
    engine does (tests/test_efficiency.py's case)."""
    cfg = dict(_BASE, prefill_buckets=(32, 64), kv_len_buckets=(64, 256))
    prompts = [list(range(3, 93))]
    rows = [dict(temperature=0.0, max_tokens=6, ignore_eos=True)]
    got = _run(_port(tiny[1], **cfg), SamplingOptions, prompts, rows)
    want = _run(jengine.LLMEngine(jec.EngineConfig(**cfg), params=tiny[0]),
                JSamplingOptions, prompts, rows)
    assert got == want
    assert got[2] and all(w[:3] == (4, 4, 256) for w in got[2])


# ------------------------------------------------ (f) the KV admission gate

def test_kv_deferred_gates_admission_imminent(tiny):
    """A waiter with a free slot makes admission imminent unless the
    last scheduler pass held it back on the KV gate: both schedulers set
    kv_deferred alike, and both engines' _admission_imminent reads it;
    a pool too small for the waiter defers it for real."""
    for sched_mod in (tscheduler, jscheduler):
        sched = sched_mod.Scheduler(max_num_seqs=2, max_model_len=64,
                                    prefill_chunk=16)
        sched.add(sched_mod.Sequence("w1", list(range(4)),
                                     sched_mod.SamplingOptions()))
        gate = {"ok": False}
        sched.can_admit = lambda seq: gate["ok"]
        sched.schedule()
        assert sched.waiting and sched.free_slots and sched.kv_deferred
        gate["ok"] = True
        sched.schedule()
        assert not sched.kv_deferred and not sched.waiting
    cfg = dict(_BASE, max_num_seqs=2)
    te = _port(tiny[1], **cfg)
    je = jengine.LLMEngine(jec.EngineConfig(**cfg), params=tiny[0])
    for eng, opts in ((te, SamplingOptions), (je, JSamplingOptions)):
        eng.add_request([1, 2, 3], opts(max_tokens=4))
        assert eng._admission_imminent()
        eng.scheduler.can_admit = lambda seq: False
        eng.scheduler.schedule()
        assert not eng._admission_imminent()
    # a real deferral: the first request holds most of a one-sequence
    # pool, the second's prompt does not fit beside it
    te = _port(tiny[1], **dict(cfg, max_model_len=128, kv_block_size=8,
                               kv_pool_tokens=128))
    te.add_request(list(range(1, 101)), SamplingOptions(
        temperature=0.0, max_tokens=20, ignore_eos=True))
    te.step()
    te.add_request(list(range(1, 61)), SamplingOptions(
        temperature=0.0, max_tokens=4, ignore_eos=True))
    te.step()
    assert te.scheduler.waiting and te.scheduler.free_slots
    assert te.scheduler.kv_deferred and not te._admission_imminent()


# ----------------------------------------- (g) variants that pin geometry

@pytest.mark.parametrize("special", [
    dict(temperature=0.8, seed=7),
    dict(temperature=0.0, guided_regex=r"\d{12}"),
    dict(temperature=0.0, presence_penalty=0.5),
    dict(temperature=0.0, top_logprobs=2),
], ids=["seeded", "guided", "shaped", "top_logprobs"])
def test_variants_outside_the_grid_pin_full_geometry(tiny, jax_engines,
                                                     special):
    """A seeded, guided, shaped or top_logprobs row keeps every window
    of the batch at (max_num_seqs, decode_window) while it runs, on both
    engines; greedy tokens equal JAX's (a seeded row's noise differs
    between the packages, ROADMAP Queue C item 2: its tokens are not
    compared)."""
    prompts = [list(range(5, 20)), list(range(9, 30))]
    rows = [dict(temperature=0.0, max_tokens=6, ignore_eos=True),
            dict(special, max_tokens=24, ignore_eos="guided_regex"
                 not in special)]
    got = _run(_port(tiny[1], **_BASE), SamplingOptions, prompts, rows)
    want = _run(jax_engines.get(**_BASE), JSamplingOptions, prompts, rows)
    assert got[2] == want[2]
    assert got[2] and all(w[:2] == (4, 4) for w in got[2])
    if "seed" in special:
        assert got[0][0] == want[0][0]
    else:
        assert got[0] == want[0] and got[1] == want[1]


# ---------------------------------- (h) abort and migrate, windows in flight

def test_abort_and_migrate_with_two_windows_in_flight(tiny, jax_engines,
                                                      tmp_path):
    """At depth 3 two windows stay in flight between steps. Aborting a
    sequence then discards its rows (it takes no token after the abort),
    and migrate_out preempts another, which re-admits by injection; the
    other streams, and the migrated one, equal the JAX engine's
    undisturbed tokens."""
    prompts, rows = _staggered(4)
    want = _run(jax_engines.get(**_BASE), JSamplingOptions, prompts,
                rows)[0]
    te = _port(tiny[1], **dict(_BASE, pipeline_depth=3), kv_transfer_config={
        "kv_role": "kv_both", "chunk_size": 8,
        "local_disk_path": str(tmp_path)})
    seen = {}

    def disturb(eng, step, ids):
        if "abort" in seen or len(eng._inflight) < 2:
            return
        in_flight = {s.seq_id for w in eng._inflight for s in w[5]}
        assert {ids[1], ids[2]} <= in_flight
        seen["abort"] = len(eng.seqs[ids[1]].output_tokens)
        assert eng.abort(ids[1])
        seen["hit"] = eng.connector.hit_tokens
        out = eng.migrate_out(max_seqs=1)
        assert len(out["migrated"]) == 1 and out["freed_blocks"] > 0
        assert out["migrated"][0] != ids[1]

    got, reasons, _ = _run(te, SamplingOptions, prompts, rows, hook=disturb)
    assert "abort" in seen
    assert reasons[1] == "abort" and len(got[1]) == seen["abort"]
    assert got[1] == want[1][:seen["abort"]]
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert te.connector.hit_tokens > seen["hit"]
    te.close()


# --------------------------------------------- (i) rolling KV at depth 2

def test_rolling_kv_at_depth_2_equals_depth_1_and_jax():
    """debug-sliding (a 64-token window on every layer) with blocks
    rolling behind the window on a tight pool: the port's tokens at
    pipeline_depth 2 equal its tokens at depth 1 and the JAX engine's at
    depth 1 on each of 5 runs (the JAX engine's own tokens vary at depth
    2 here, ROADMAP Queue C item 6)."""
    jparams, tparams = _weights("debug-sliding", 0)
    cfg = dict(model="debug-sliding", dtype="float32", kv_dtype="float32",
               max_model_len=512, max_num_seqs=2, prefill_chunk=32,
               prefill_buckets=(32,), decode_window=4, kv_block_size=16,
               kv_pool_tokens=256)
    prompts = [list(range(3 + j, 35 + j)) for j in range(2)]
    rows = [dict(temperature=0.0, max_tokens=120, ignore_eos=True)] * 2
    want = _run(jengine.LLMEngine(jec.EngineConfig(
        **cfg, window_adapt=False, pipeline_depth=1), params=jparams),
        JSamplingOptions, prompts, rows)[0]
    assert _run(_port(tparams, **cfg, pipeline_depth=1), SamplingOptions,
                prompts, rows)[0] == want
    for _ in range(5):
        te = _port(tparams, **cfg, pipeline_depth=2)
        rolled = []
        got = _run(te, SamplingOptions, prompts, rows,
                   hook=lambda eng, step, ids: rolled.extend(
                       eng.seqs[i].rolled_blocks for i in ids))
        assert got[0] == want
        assert max(rolled) > 0
        assert [float(line.rsplit(" ", 1)[1]) for line in
                te.render_metrics().decode().splitlines()
                if line.startswith("vllm:num_preemptions_total")] == [0.0]


# ------------------------------------------------------ (j) server flags

class _Built(Exception):
    pass


@pytest.mark.parametrize("argv", [
    [],
    ["--no-window-adapt"],
    ["--decode-batch-buckets", "1,3,8", "--decode-window-buckets", "2,4",
     "--pipeline-depth", "3", "--max-num-seqs", "6"],
    ["--decode-window", "5", "--pipeline-depth", "1"],
])
def test_server_flags_equal_jax(monkeypatch, argv):
    """The four flags parse, with JAX's defaults, into the EngineConfig
    fields the JAX server's main builds from them."""
    built = {}

    def capture(name):
        def engine(cfg, *a, **kw):
            built[name] = cfg
            raise _Built()
        return engine

    monkeypatch.setattr(jserver, "AsyncLLMEngine", capture("jax"))
    monkeypatch.setattr(tserver, "AsyncLLMEngine", capture("port"))
    for main, extra in ((jserver.main, []),
                        (tserver.main, ["--device", "cpu"])):
        with pytest.raises(_Built):
            main(["--model", "debug-tiny"] + argv + extra)
    for f in ("window_adapt", "decode_batch_buckets",
              "decode_window_buckets", "pipeline_depth", "decode_window",
              "max_num_seqs"):
        assert getattr(built["port"], f) == getattr(built["jax"], f), f
