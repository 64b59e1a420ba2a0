"""The PyTorch port's engine surface against the JAX package's on the
CPU: the load report and the metrics exposition as the router, the
autoscaler and the kvplane read them (signals.parse_load_report,
router/stats.parse_engine_metrics), overload answers (bounded
admission, deadlines, the queue-delay shed), the small routes
(/tokenize, /detokenize, /version) and the choice grid of n > 1 and
several prompts.

Engines run debug-tiny; where two servers are compared their weights
are drawn once by the JAX package and carried across
(weights.params_from_jax) in float32, so greedy text agrees exactly.
"""

import asyncio
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.router.stats import parse_engine_metrics
from production_stack_tpu.signals import parse_load_report
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.engine import AdmissionRejected
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

ROUTER_GAUGES = ("vllm:num_requests_running", "vllm:num_requests_waiting",
                 "vllm:gpu_cache_usage_perc", "tpu:hbm_kv_usage_perc",
                 "vllm:gpu_prefix_cache_hit_rate",
                 "tpu:engine_capacity_seqs", "tpu:est_queue_delay_ms")
LOAD_HEADERS = ("x-engine-queue-depth", "x-engine-running",
                "x-engine-free-kv-blocks", "x-engine-est-queue-delay-ms")


def _serve(app, coro):
    async def runner():
        async with TestClient(TestServer(app)) as client:
            return await coro(client)
    return asyncio.run(runner())


def _totals(text: str) -> dict:
    """{sample name: value} of an exposition (one series per name)."""
    return {s.name: s.value for f in text_string_to_metric_families(text)
            for s in f.samples}


def _chat_body(content="hi", **kw):
    return {"model": "debug-tiny",
            "messages": [{"role": "user", "content": content}],
            "max_tokens": 4, "temperature": 0.0, **kw}


# ----------------------------------------------------- overload engine

@pytest.fixture(scope="module")
def engine():
    """One slot and a waiting bound of 2, with room for a long hold (a
    stream that keeps the slot busy while the tests queue behind it)."""
    eng = AsyncLLMEngine(tec.EngineConfig(
        model="debug-tiny", device="cpu", max_model_len=2048,
        max_num_seqs=1, prefill_chunk=32, prefill_buckets=(16, 32),
        kv_block_size=16, max_waiting_seqs=2))
    eng.engine.runner.warmup()
    return eng


async def _occupy_slot(client):
    """A long stream on the single slot; close() releases it. post()
    returns once the first payload is out: the sequence is running."""
    resp = await client.post("/v1/chat/completions", json=_chat_body(
        "hold", max_tokens=1900, stream=True, ignore_eos=True))
    assert resp.status == 200
    await resp.content.readany()
    return resp


def test_load_and_metrics_read_by_the_router_parsers(engine):
    """/load through signals.parse_load_report and /metrics through
    router/stats.parse_engine_metrics, with a request running and two
    waiting (the engine loop held still under the engine lock): every
    field the router, the autoscaler and the kvplane read equals the
    engine's own state, and the exposition parses with
    prometheus_client and holds the seven router gauges."""
    eng = engine.engine

    async def body(client):
        hold = await _occupy_slot(client)
        toks = eng.tokenizer.encode("queued")
        with eng._lock:
            ids = [eng.add_request(list(toks), SamplingOptions(max_tokens=2))
                   for _ in range(2)]
            r = await client.get("/load")
            assert r.status == 200
            report = await r.json()
            load = parse_load_report(report)
            assert (load.running, load.queue_depth) == (1, 2)
            assert load.capacity == 3 and load.max_num_seqs == 1
            assert load.free_kv_blocks == eng.block_mgr.available
            assert load.kv_usage == round(eng.block_mgr.usage, 4) > 0
            assert load.models == ("debug-tiny",)
            assert load.token_steps_real > 0
            assert report["kv_pool"]["active"] == \
                eng.block_mgr.active_blocks
            r = await client.get("/metrics")
            assert r.status == 200
            text = await r.text()
            stats = parse_engine_metrics(text)
            assert (stats.num_running, stats.num_waiting) == (1, 2)
            assert stats.capacity == 3
            assert stats.kv_usage == pytest.approx(eng.block_mgr.usage)
            assert stats.est_queue_delay_ms == pytest.approx(
                1e3 * eng.estimated_queue_delay_s())
            names = {f.name for f in text_string_to_metric_families(text)}
            assert set(ROUTER_GAUGES) <= names
            for h in LOAD_HEADERS:
                assert h in r.headers
            for sid in ids:
                assert eng.abort(sid)
        hold.close()
    _serve(build_app(engine), body)


def test_load_and_metrics_shapes_equal_the_jax_engines(engine):
    """The port's /load has the JAX engine's keys (less kv_cache, which
    only a KV-tier connector adds) in its top level, perf and kv_pool
    blocks (the kvplane's defrag_runs and defrag_block_moves included),
    and every /metrics family the port exports exists in the JAX
    engine's exposition under the same name and type."""
    je = jengine.LLMEngine(jec.EngineConfig(model="debug-tiny",
                                           max_model_len=64,
                                           max_num_seqs=1))
    want, got = je.load_report(), engine.engine.load_report()
    assert set(got) == set(want) - {"kv_cache"}
    assert set(got["perf"]) == set(want["perf"])
    assert set(got["perf"]["token_steps"]) == \
        set(want["perf"]["token_steps"])
    assert set(got["kv_pool"]) == set(want["kv_pool"])
    jfams = {f.name: f.type for f in text_string_to_metric_families(
        je.render_metrics().decode())}
    tfams = {f.name: f.type for f in text_string_to_metric_families(
        engine.engine.render_metrics().decode())}
    assert tfams.items() <= jfams.items()


def test_bounded_admission_rejects_at_submit(engine):
    """With the loop held, a waiting queue at max_waiting_seqs plus the
    free slots refuses the next submit with AdmissionRejected."""
    eng = engine.engine
    toks = eng.tokenizer.encode("overflow")
    before = _totals(eng.render_metrics().decode())
    with eng._lock:
        ids = [eng.add_request(list(toks), SamplingOptions(max_tokens=2))
               for _ in range(3)]
        with pytest.raises(AdmissionRejected) as exc:
            eng.add_request(list(toks), SamplingOptions(max_tokens=2))
        assert exc.value.queue_depth == 3
        for sid in ids:
            assert eng.abort(sid)
    after = _totals(eng.render_metrics().decode())
    assert after["tpu:admission_rejected_total"] == \
        before["tpu:admission_rejected_total"] + 1


def test_overload_answers_503_and_504_as_jax(engine):
    """Bounded admission: 503 + Retry-After; an already-elapsed
    deadline: 504 + x-deadline-expired before any engine work; a
    queued request whose deadline passes: 504 (streamed too); one
    queued past max_queue_delay_ms: 503."""
    eng = engine.engine

    async def body(client):
        hold = await _occupy_slot(client)
        toks = eng.tokenizer.encode("fill")
        ids = [eng.add_request(list(toks), SamplingOptions(max_tokens=2))
               for _ in range(2)]
        r = await client.post("/v1/chat/completions", json=_chat_body())
        assert r.status == 503
        assert int(r.headers["Retry-After"]) >= 1
        assert "overloaded" in (await r.json())["error"]["message"]
        for h in LOAD_HEADERS:
            assert h in r.headers
        for sid in ids:
            eng.abort(sid)
        r = await client.post("/v1/completions", json={
            "model": "debug-tiny", "prompt": "x", "max_tokens": 2},
            headers={"x-request-deadline-ms": "0"})
        assert r.status == 504
        assert r.headers["x-deadline-expired"] == "1"
        for stream in (False, True):
            t0 = time.monotonic()
            r = await client.post(
                "/v1/chat/completions",
                json=_chat_body("queued", stream=stream),
                headers={"x-request-deadline-ms": "300"})
            assert r.status == 504, await r.text()
            assert r.headers["x-deadline-expired"] == "1"
            assert time.monotonic() - t0 < 5.0
        dropped = [s for s in eng.seqs.values()
                   if s.finish_reason == "deadline"]
        assert dropped and all(not s.output_tokens for s in dropped)
        eng.cfg.max_queue_delay_ms = 300.0
        try:
            r = await client.post("/v1/chat/completions",
                                  json=_chat_body("capped"))
            assert r.status == 503
            assert int(r.headers["Retry-After"]) >= 1
        finally:
            eng.cfg.max_queue_delay_ms = None
        hold.close()
        r = await client.get("/metrics")
        totals = _totals(await r.text())
        assert totals["tpu:deadline_expired_total"] >= 2
        assert totals["tpu:queue_delay_shed_total"] >= 1
    _serve(build_app(engine), body)


# ------------------------------------------------ the JAX server beside

def _weights(seed=0):
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(np_params, tcfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port engine on the same float32 weights."""
    jparams, tparams = _weights(11)
    common = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
                  max_model_len=128, max_num_seqs=4, prefill_chunk=32,
                  prefill_buckets=(16, 32), decode_window=4,
                  kv_block_size=8)
    je = jasync.AsyncLLMEngine(jec.EngineConfig(**common,
                                                window_adapt=False),
                               params=jparams)
    te = AsyncLLMEngine(tec.EngineConfig(**common, device="cpu"),
                        params=tparams)
    return je, te


def _both(pair, coro):
    """coro's result against the JAX server, then against the port's."""
    je, te = pair
    return [_serve(jserver.build_app(je, api_key=""), coro),
            _serve(build_app(te), coro)]


@pytest.mark.parametrize("path,body", [
    ("/tokenize", {"prompt": "héllo, world"}),
    ("/detokenize", {"tokens": [256, 104, 195, 169, 108, 108, 111]}),
    ("/version", None),
])
def test_small_routes_answer_as_jax(pair, path, body):
    async def call(client):
        r = await (client.get(path) if body is None
                   else client.post(path, json=body))
        assert r.status == 200
        for h in LOAD_HEADERS:
            assert h in r.headers
        return await r.json()
    want, got = _both(pair, call)
    assert got == want


def _strip(resp: dict) -> dict:
    """A response without what differs between two servers' calls."""
    return {"choices": resp["choices"], "usage": resp["usage"]}


@pytest.mark.parametrize("path,extra", [
    ("/v1/completions", {"prompt": "abc", "n": 3}),
    ("/v1/completions", {"prompt": ["abc", "de"], "n": 2}),
    ("/v1/completions", {"prompt": [[256, 7, 8, 9, 10], [256, 1, 2]]}),
    ("/v1/completions", {"prompt": ["one", "two"], "logprobs": 2,
                         "echo": True}),
    ("/v1/chat/completions", {"n": 2, "logprobs": True,
                              "top_logprobs": 3,
                              "messages": [{"role": "user",
                                            "content": "hey"}]}),
], ids=["n3", "two-prompts-n2", "two-token-prompts", "two-prompts-echo",
        "chat-n2-top3"])
def test_choice_grid_equals_the_jax_servers(pair, path, extra):
    """n > 1 and several prompts, greedy: the choices (index, text,
    finish reason, logprob blocks to 1e-4) and usage equal the JAX
    server's, and the n choices of one prompt are identical."""
    body = {"model": "debug-tiny", "max_tokens": 5, "temperature": 0.0,
            "ignore_eos": True, **extra}

    async def call(client):
        r = await client.post(path, json=body)
        assert r.status == 200, await r.text()
        return _strip(await r.json())
    want, got = _both(pair, call)
    assert got["usage"] == want["usage"]
    assert [c["index"] for c in got["choices"]] == \
        [c["index"] for c in want["choices"]]
    n = extra.get("n", 1)
    for g, w in zip(got["choices"], want["choices"]):
        key = "message" if "message" in g else "text"
        assert g[key] == w[key]
        assert g["finish_reason"] == w["finish_reason"]
        _close(g["logprobs"], w["logprobs"])
    for i in range(0, len(got["choices"]), n):
        group = got["choices"][i:i + n]
        key = "message" if "message" in group[0] else "text"
        assert all(c[key] == group[0][key] for c in group)


def test_out_of_vocab_ids_answer_as_jax(pair):
    """Prompt ids outside the vocabulary (V = 512) sent with echo and
    logprobs, and min_tokens with a stop id outside it: the port answers
    200 with the JAX server's choices (a prompt target outside the
    vocabulary has a NaN logprob in both), then serves the next
    request. A negative prompt id with echo answers 200 on the port (the
    JAX server's byte tokenizer raises on it, 500) with NaN where the
    id lies below -V."""
    bodies = [
        {"prompt": [1, 600, 700, 511, 3], "echo": True, "logprobs": 1},
        {"prompt": [1, 5, 6], "min_tokens": 3, "stop_token_ids": [517, 42],
         "logit_bias": {"42": 100.0}},
        {"prompt": "after"},
    ]

    async def call(client):
        out = []
        for extra in bodies:
            r = await client.post("/v1/completions", json={
                "model": "debug-tiny", "max_tokens": 4,
                "temperature": 0.0, **extra})
            assert r.status == 200, await r.text()
            out.append(_strip(await r.json()))
        return out
    want, got = _both(pair, call)
    _close(got, want)
    lps = got[0]["choices"][0]["logprobs"]["token_logprobs"]
    assert [math.isnan(v) for v in lps[1:5]] == [True, True, False, False]
    # the floor bans 42 for three tokens; 517 lies outside the
    # vocabulary and bans nothing
    assert got[1]["choices"][0]["finish_reason"] == "stop"
    assert got[1]["usage"]["completion_tokens"] == 4

    async def negative(client):
        r = await client.post("/v1/completions", json={
            "model": "debug-tiny", "max_tokens": 2, "temperature": 0.0,
            "prompt": [1, -5, -600, 3], "echo": True, "logprobs": 1})
        assert r.status == 200, await r.text()
        lp = (await r.json())["choices"][0]["logprobs"]["token_logprobs"]
        r = await client.post("/v1/completions", json={
            "model": "debug-tiny", "max_tokens": 2, "prompt": "after"})
        assert r.status == 200
        return lp
    lp = _serve(build_app(pair[1]), negative)
    assert lp[0] is None and not math.isnan(lp[1])
    assert math.isnan(lp[2]) and not math.isnan(lp[3])


def _close(a, b, tol=1e-4):
    """Equal JSON, numbers to tol."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol or (math.isnan(a) and math.isnan(b)), \
            (a, b)
    else:
        assert a == b


def test_streamed_choice_grid_equals_the_jax_servers(pair):
    """Streamed n = 3 with a seed: each choice's concatenated deltas
    and the usage chunk; the choice indices 0..2 equal the JAX
    server's (sampled text differs by design: the noise is not
    jax.random's)."""
    body = {"model": "debug-tiny", "prompt": "abc", "n": 3, "seed": 5,
            "max_tokens": 6, "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}

    async def call(client):
        r = await client.post("/v1/completions", json=body)
        assert r.status == 200
        events = [ln[6:] for ln in (await r.read()).decode().splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        per = {}
        for c in chunks[:-1]:
            for ch in c["choices"]:
                per.setdefault(ch["index"], []).append(ch)
        return per, chunks[-1]["usage"]
    (wper, wusage), (tper, tusage) = _both(pair, call)
    assert tusage == wusage
    assert sorted(tper) == sorted(wper) == [0, 1, 2]
    for i in tper:
        assert tper[i][-1]["finish_reason"] == "length"
