"""Request tracing and API keys of the PyTorch port against the JAX
package on the CPU: the tracing module's units (traceparent, the
recorder, the ring, sealing, unattributed time) run on both modules with
equal results; the trace middleware, /debug/traces, /debug/perf and
ENGINE_API_KEY enforcement answer alike on a JAX and a port engine
server (debug-tiny); the engines' terminal timing; and the span layout
the server draws from a timing (admitted, preempted, never admitted) in
both packages.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu import tracing as jtracing
from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.engine.scheduler import \
    SamplingOptions as JSamplingOptions
from production_stack_tpu_torch import tracing as ttracing
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions

from tests.torch_geometry import FIXED

MODULES = {"jax": jtracing, "port": ttracing}
COMMON = dict(model="debug-tiny", max_model_len=128, max_num_seqs=2,
              prefill_chunk=32, prefill_buckets=(16, 32))
LOAD_HEADERS = ("x-engine-queue-depth", "x-engine-running",
                "x-engine-free-kv-blocks", "x-engine-est-queue-delay-ms")


# ------------------------------------------------------------- the units

def _roundtrip(t):
    tid, sid = t.new_trace_id(), t.new_span_id()
    out = []
    for sampled in (True, False):
        hdr = t.format_traceparent(tid, sid, sampled=sampled)
        out.append(t.parse_traceparent(hdr) == (tid, sid, sampled))
    return out + [len(tid), len(sid)]


_BAD_HEADERS = [
    None, "", "garbage", "00-xyz-abc-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",     # all-zero trace id
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",     # all-zero span id
    "ff-" + "a" * 32 + "-" + "1" * 16 + "-01",     # forbidden version
    "00-" + "a" * 31 + "-" + "1" * 16 + "-01",     # short trace id
]


def _malformed(t):
    return [t.parse_traceparent(bad) for bad in _BAD_HEADERS]


def _continues_inbound(t):
    rec = t.TraceRecorder("t")
    tid, sid = t.new_trace_id(), t.new_span_id()
    tr = rec.begin(t.format_traceparent(tid, sid))
    child = t.parse_traceparent(tr.child_traceparent())
    return [tr.trace_id == tid, tr.parent_id == sid, tr.sampled,
            child == (tid, tr.span_id, True)]


def _unsampled_wins(t):
    rec = t.TraceRecorder("t", sample_rate=1.0)
    tr = rec.begin(t.format_traceparent(t.new_trace_id(), t.new_span_id(),
                                        sampled=False))
    rec.finish(tr)
    return [len(rec.ring), rec.traces_started, rec.traces_recorded]


def _ring_bounded(t):
    rec = t.TraceRecorder("t", ring_entries=8)
    for i in range(100):
        tr = rec.begin(name=f"req-{i}")
        tr.add_phase("p", tr.t0, tr.t0 + 0.001)
        rec.finish(tr)
    return [len(rec.ring), rec.traces_recorded, rec.last_seq,
            [x.name for x in rec.ring], [x.seq for x in rec.ring],
            [r["seq"] for r in rec.snapshot(since_seq=97)]]


def _late_spans_dropped(t):
    rec = t.TraceRecorder("t")
    tr = rec.begin()
    tr.add_phase("a", tr.t0, tr.t0 + 0.5)
    rec.finish(tr)
    n = len(tr.spans)
    tr.add_event("late-prefill", None, 1.0)
    rec.finish(tr)                             # a second seal: no-op
    return [n, len(tr.spans), len(rec.ring)]


def _unattributed(t):
    rec = t.TraceRecorder("t")
    tr = rec.begin()
    tr.add_phase("a", tr.t0, tr.t0 + 0.25)
    tr.add_event("overlapping", tr.t0, 5.0)    # events never count
    tr.seal("ok", end=tr.t0 + 1.0)
    row = tr.render()
    return [round(tr.duration_s, 9), {k: round(v, 9) for k, v in
                                      tr.phase_totals().items()},
            round(tr.unattributed_s(), 9), row["unattributed_ms"],
            [(s["name"], s["kind"], s["start_ms"], s["duration_ms"])
             for s in row["spans"]], sorted(row)]


UNIT_CASES = {
    "traceparent_roundtrip": (_roundtrip, [True, True, 32, 16]),
    "traceparent_malformed": (_malformed, [None] * len(_BAD_HEADERS)),
    "recorder_continues_inbound_context": (_continues_inbound,
                                           [True] * 4),
    "inbound_unsampled_flag_wins": (_unsampled_wins, [0, 1, 0]),
    "ring_bounded_under_churn": (_ring_bounded, [
        8, 100, 100, [f"req-{i}" for i in range(92, 100)],
        list(range(93, 101)), [98, 99, 100]]),
    "sealed_trace_drops_late_spans": (_late_spans_dropped, [1, 1, 1]),
    "unattributed_accounting": (_unattributed, None),
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_tracing_units_equal_jax(case):
    """tests/test_tracing.py's unit setups on both tracing modules:
    equal results, and the results those tests assert."""
    fn, want = UNIT_CASES[case]
    got = {name: fn(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["jax"]
    if want is not None:
        assert got["port"] == want
    else:
        duration, phases, unattributed, *_ = got["port"]
        assert duration == pytest.approx(1.0)
        assert phases == {"a": pytest.approx(0.25)}
        assert unattributed == pytest.approx(0.75)


# -------------------------------------------------- the span layout

def _timing_cases():
    now = time.monotonic()
    base = dict(arrival=now - 2.0, end=now - 0.5, prompt_tokens=7,
                output_tokens=3, kv_prefetch_wait_s=0.0,
                kv_cached_tokens=0)
    return {
        # admitted once, the first token 0.5 s after admission
        "admitted": dict(base, admit=now - 1.8, first_token=now - 1.3,
                         queue_wait_s=0.2),
        # preempted after its first token and re-admitted: the waits
        # sum, the first token precedes the last admission
        "preempted": dict(base, admit=now - 1.0, first_token=now - 1.5,
                          queue_wait_s=0.6),
        # a queue-delay or deadline drop: never admitted
        "never_admitted": dict(base, admit=None, first_token=None,
                               queue_wait_s=1.5, output_tokens=0),
        # a KV-tier hit: the prefetch wait rides as an event
        "kv_prefetch": dict(base, admit=now - 1.8, first_token=now - 1.3,
                            queue_wait_s=0.2, kv_prefetch_wait_s=0.125,
                            kv_cached_tokens=2816),
    }


@pytest.mark.parametrize("case", sorted(_timing_cases()))
def test_seal_engine_trace_spans_equal_jax(case):
    """The server's span layout from one terminal timing, in both
    packages: the same spans in the same order and kinds, the same
    durations for every span the timing fixes (postprocess runs to the
    seal's own clock), the same attrs; a never-admitted sequence renders
    its engine life as queue_wait and never as prefill; a preempted one
    its cumulative wait, with prefill clamped to zero."""
    rows = {}
    for name, (mod, server) in {"jax": (jtracing, jserver),
                                "port": (ttracing, tserver)}.items():
        timing = _timing_cases()[case]
        tracer = mod.TraceRecorder("engine")
        trace = tracer.begin()
        trace.t0 = timing["arrival"] - 0.25
        request = {"seq_timing": timing, "trace_tokenize_s": 0.001}
        fake = SimpleNamespace(app={}, get=request.get)
        server._seal_engine_trace(tracer, trace, fake, "ok")
        rows[name] = tracer.snapshot()[0]

    def fixed(row):
        return ([(s["name"], s["kind"],
                  None if s["name"] == "postprocess" else s["duration_ms"],
                  s.get("attrs")) for s in row["spans"]],
                row["attrs"], row["status"])
    assert fixed(rows["port"]) == fixed(rows["jax"])
    phases = [s["name"] for s in rows["port"]["spans"]
              if s["kind"] == "phase"]
    spans = {s["name"]: s for s in rows["port"]["spans"]}
    if case == "never_admitted":
        assert phases == ["preprocess", "queue_wait", "postprocess"]
        assert spans["queue_wait"]["duration_ms"] == pytest.approx(1500.0)
    else:
        assert phases == ["preprocess", "queue_wait", "prefill", "decode",
                          "postprocess"]
    if case == "preempted":
        assert spans["queue_wait"]["duration_ms"] == pytest.approx(600.0)
        assert spans["prefill"]["duration_ms"] == 0.0
    if case == "kv_prefetch":
        assert spans["kv_prefetch"]["kind"] == "event"
        assert spans["kv_prefetch"]["attrs"] == {"cached_tokens": 2816}


# ---------------------------------------------------------- the engines

def test_terminal_timing_equal_jax():
    """A finished sequence's terminal output carries the timing, its
    other outputs none; a sequence dropped while waiting (its deadline
    passed) carries one with no admission. Keys and counts as the JAX
    engine's."""
    je = jengine.LLMEngine(jec.EngineConfig(**COMMON, **FIXED))
    te = tengine.LLMEngine(tec.EngineConfig(**COMMON, device="cpu",
                                            **FIXED))
    got = {}
    for name, eng, opts in (("jax", je, JSamplingOptions),
                            ("port", te, SamplingOptions)):
        sid = eng.add_request([1, 2, 3, 4, 5], opts(
            temperature=0.0, max_tokens=4, ignore_eos=True))
        late = eng.add_request([1, 2], opts(max_tokens=2),
                               deadline=time.monotonic() - 1.0)
        outs = []
        while eng.has_work:
            outs.extend(eng.step())
        mine = [o for o in outs if o.seq_id == sid]
        dropped = [o for o in outs if o.seq_id == late]
        assert all(o.timing is None for o in mine[:-1])
        t, d = mine[-1].timing, dropped[-1].timing
        assert t["arrival"] <= t["admit"] <= t["first_token"] <= t["end"]
        assert d["admit"] is None and d["first_token"] is None
        assert dropped[-1].finish_reason == "deadline"
        got[name] = (sorted(t), sorted(d), len(mine),
                     {k: t[k] for k in ("prompt_tokens", "output_tokens",
                                        "kv_prefetch_wait_s",
                                        "kv_cached_tokens")},
                     {k: d[k] for k in ("prompt_tokens", "output_tokens")})
    assert got["port"] == got["jax"]


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine on debug-tiny (float32 port weights of
    their own: these tests compare statuses and span layouts, not
    tokens)."""
    je = jasync.AsyncLLMEngine(jec.EngineConfig(**COMMON))
    te = AsyncLLMEngine(tec.EngineConfig(**COMMON, device="cpu",
                                         dtype="float32"))
    return je, te


def _serve(app, coro):
    async def runner():
        async with TestClient(TestServer(app)) as client:
            return await coro(client)
    return asyncio.run(runner())


def _both(engines, coro, **kw):
    """coro against the JAX server, then against the port's."""
    je, te = engines
    return [_serve(jserver.build_app(je, **kw), coro),
            _serve(tserver.build_app(te, **kw), coro)]


def _chat(content="trace me", **kw):
    return {"model": "debug-tiny", "max_tokens": 4, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": content}], **kw}


def test_engine_trace_spans_and_propagation(engines):
    """tests/test_engine_server.py's trace test on both servers: an
    inbound traceparent is continued (x-trace-id, the parent span), the
    phases and events are named and ordered alike (the JAX engine's XLA
    compile events aside: the port compiles none), with the same status
    and output tokens; a streamed request carries its trace id in the
    SSE headers; the phase histograms advance."""
    async def body(client):
        out = []
        for stream in (False, True):
            tid, sid = ttracing.new_trace_id(), ttracing.new_span_id()
            r = await client.post(
                "/v1/chat/completions", json=_chat(stream=stream),
                headers={"traceparent": ttracing.format_traceparent(
                    tid, sid)})
            assert r.status == 200
            await r.read()
            assert r.headers["x-trace-id"] == tid
            r = await client.get("/debug/traces", params={"trace_id": tid})
            rows = (await r.json())["traces"]
            assert len(rows) == 1
            t = rows[0]
            assert t["parent_id"] == sid and t["trace_id"] == tid
            assert t["unattributed_ms"] <= 0.25 * t["duration_ms"] + 5.0
            out.append(([s["name"] for s in t["spans"]
                         if s["kind"] == "phase"],
                        sorted(s["name"] for s in t["spans"]
                               if s["kind"] == "event"
                               and s["name"] != "xla_compile"),
                        t["status"], t["attrs"]["output_tokens"], sorted(t)))
        r = await client.get("/metrics")
        text = await r.text()
        assert 'phase="decode"' in text
        return out
    jax_rows, port_rows = _both(engines, body, api_key="")
    assert port_rows == jax_rows
    phases, events, status, n_out, _ = port_rows[0]
    assert phases == ["preprocess", "queue_wait", "prefill", "decode",
                      "postprocess"]
    assert events == ["tokenize"] and status == "ok" and n_out == 4


def test_engine_shed_trace_sealed(engines):
    """A 400 (no sequence made) still seals a trace: status http_400, one
    preprocess phase, on both servers."""
    async def body(client):
        r = await client.post("/v1/chat/completions", json=_chat(n=0))
        assert r.status == 400
        tid = r.headers["x-trace-id"]
        r = await client.get("/debug/traces", params={"trace_id": tid})
        row = (await r.json())["traces"][0]
        return row["status"], [s["name"] for s in row["spans"]
                               if s["kind"] == "phase"]
    got = _both(engines, body, api_key="")
    assert got[1] == got[0] == ("http_400", ["preprocess"])


# the route grid of the API-key checks: (method, path, body)
ROUTES = [
    ("GET", "/health", None), ("GET", "/metrics", None),
    ("GET", "/version", None), ("GET", "/load", None),
    ("GET", "/v1/models", None), ("GET", "/debug/traces", None),
    ("GET", "/debug/perf", None),
    ("POST", "/v1/completions", {"model": "debug-tiny", "prompt": "hi",
                                 "max_tokens": 2, "temperature": 0.0}),
    ("POST", "/v1/chat/completions", _chat(max_tokens=2)),
    ("POST", "/tokenize", {"prompt": "hi"}),
    ("POST", "/detokenize", {"tokens": [104, 105]}),
    ("POST", "/v1/embeddings", {"model": "debug-tiny", "input": "hi"}),
]


def _route_statuses(key):
    """Each route's status and whether it carried the load headers and a
    trace id, with no credentials, a wrong key, a wrong non-ASCII key
    and the right key."""
    creds = {"none": {}, "wrong": {"Authorization": "Bearer wrong"},
             "non_ascii": {"Authorization": "Bearer ωrong"},
             "right": {"Authorization": f"Bearer {key}"}}

    async def body(client):
        out = {}
        for method, path, payload in ROUTES:
            for cname, headers in creds.items():
                r = await client.request(method, path, json=payload,
                                         headers=headers)
                await r.read()
                out[(path, cname)] = (
                    r.status, all(h in r.headers for h in LOAD_HEADERS),
                    "x-trace-id" in r.headers)
        return out
    return body


@pytest.mark.parametrize("key_from", ["argument", "environment"])
def test_api_key_statuses_equal_jax(engines, monkeypatch, key_from):
    """test_api_key_enforcement's and test_api_key_from_env's setups on
    both servers, with a non-ASCII key: equal statuses route by route;
    /health, /metrics, /version and /load open, the rest (/debug/*
    included) 401 without the key and 200 with it; a 401 carries no load
    header and opens no trace; a non-ASCII credential is a 401, not a
    500."""
    key = "sêkrit"
    if key_from == "environment":
        monkeypatch.setenv("ENGINE_API_KEY", key)
        kw = {}
    else:
        monkeypatch.delenv("ENGINE_API_KEY", raising=False)
        kw = {"api_key": key}
    jax_codes, port_codes = _both(engines, _route_statuses(key), **kw)
    assert port_codes == jax_codes
    open_paths = {"/health", "/metrics", "/version", "/load"}
    for (path, cname), (status, headers, traced) in port_codes.items():
        if path in open_paths or cname == "right":
            assert status == 200, (path, cname)
        else:
            assert (status, headers, traced) == (401, False, False), \
                (path, cname)


def test_api_key_unset_or_empty_is_open(engines, monkeypatch):
    """An empty ENGINE_API_KEY turns enforcement off in both servers."""
    monkeypatch.setenv("ENGINE_API_KEY", "")
    jax_codes, port_codes = _both(engines, _route_statuses("unused"))
    assert port_codes == jax_codes
    assert {s for s, _, _ in port_codes.values()} == {200}


def test_debug_perf_keys_equal_jax(engines):
    """/debug/perf after a request: JAX's top-level, totals, window and
    kv_pool keys; the port's compile ring is empty (it compiles no
    executable)."""
    async def body(client):
        r = await client.post("/v1/completions", json={
            "model": "debug-tiny", "prompt": "measure me", "max_tokens": 6,
            "temperature": 0.0, "ignore_eos": True})
        assert r.status == 200
        r = await client.get("/debug/perf?limit=5")
        assert r.status == 200
        return await r.json()
    jdp, tdp = _both(engines, body, api_key="")
    assert sorted(tdp) == sorted(jdp)
    assert sorted(tdp["totals"]) == sorted(jdp["totals"])
    assert sorted(tdp["rates"]) == sorted(jdp["rates"])
    assert sorted(tdp["kv_pool"]) == sorted(jdp["kv_pool"])
    assert tdp["windows"] and sorted(tdp["windows"][-1]) == \
        sorted(jdp["windows"][-1])
    assert tdp["compiles"] == [] and tdp["kv_pool"]["active"] == 0
    assert 1 <= len(tdp["windows"]) <= 5


def test_perf_ring_bounded_by_flag():
    """--perf-ring-entries sizes the efficiency ring /debug/perf serves;
    the three ring and sampling flags reach the config and the app, and
    a ring of 0 is refused, as in JAX."""
    args = tserver.parse_args(
        ["--device", "cpu", "--perf-ring-entries", "2",
         "--trace-ring-entries", "3", "--trace-sample-rate", "0.5",
         "--embedding-model", "debug-encoder"])
    assert (args.perf_ring_entries, args.trace_ring_entries,
            args.trace_sample_rate, args.embedding_model) == (
        2, 3, 0.5, "debug-encoder")
    with pytest.raises(ValueError, match="perf_ring_entries"):
        tec.EngineConfig(device="cpu", perf_ring_entries=0)
    with pytest.raises(ValueError, match="perf_ring_entries"):
        jec.EngineConfig(perf_ring_entries=0)
    te = AsyncLLMEngine(tec.EngineConfig(
        **COMMON, device="cpu", decode_window=2,
        perf_ring_entries=args.perf_ring_entries))

    async def body(client):
        r = await client.post("/v1/completions", json={
            "model": "debug-tiny", "prompt": "ring", "max_tokens": 9,
            "temperature": 0.0, "ignore_eos": True})
        assert r.status == 200
        r = await client.get("/debug/perf?limit=50")
        perf = await r.json()
        r = await client.get("/debug/traces")
        return perf, await r.json()
    app = tserver.build_app(te, api_key="",
                            trace_ring_entries=args.trace_ring_entries,
                            trace_sample_rate=args.trace_sample_rate)
    perf, traces = _serve(app, body)
    assert perf["totals"]["decode"]["windows"] >= 4
    assert len(perf["windows"]) == 2
    assert traces["ring_entries"] == 3 and traces["sample_rate"] == 0.5
