"""The port's server with LoRA adapters against the JAX server on the
CPU: the runtime adapter verbs (/admin/lora/load, /admin/lora/evict),
/v1/models' adapter cards, /load's models, the tpu:engine_adapter_*
series, the statuses of unknown models and of adapters on the pooling
routes, adapter completions, and the router learning a port engine's
adapters (the JAX package's test_lora_routing_through_router).

Both servers run engines on the same float32 weights with the same
.npz adapters, written by the JAX package. Statuses and bodies must be
equal; completions' tokens exactly.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import lora as jlora
from production_stack_tpu.router.stats import parse_engine_metrics
from production_stack_tpu.signals import parse_load_report
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.server import build_app, parse_args
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

from tests.torch_geometry import FIXED

ADAPTER_SERIES = ("tpu:engine_adapter_loads_total",
                  "tpu:engine_adapter_evictions_total",
                  "tpu:engine_adapters_loaded")


def _serve(app, coro):
    async def runner():
        async with TestClient(TestServer(app)) as client:
            return await coro(client)
    return asyncio.run(runner())


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_server")
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    out = {}
    for name, seed in (("ad-one", 11), ("ad-two", 22), ("ad-new", 33)):
        out[name] = str(d / f"{name}.npz")
        jlora.save_adapter_npz(
            jlora.random_adapter(jcfg, lcfg, jax.random.PRNGKey(seed)),
            out[name])
    return out


@pytest.fixture(scope="module")
def pair(adapters):
    """A JAX and a port engine on the same float32 weights, serving
    ad-one and ad-two (rank 4, q and v)."""
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(12))
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams),
        dataclasses.replace(tconfig.get_config("debug-tiny"),
                            dtype=torch.float32), device="cpu")
    common = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
                  max_model_len=128, max_num_seqs=4, prefill_chunk=32,
                  prefill_buckets=(32,), decode_window=4, kv_block_size=8,
                  lora_rank=4, lora_alpha=8.0,
                  lora_adapters={n: adapters[n]
                                 for n in ("ad-one", "ad-two")})
    je = jasync.AsyncLLMEngine(jec.EngineConfig(**common,
                                                **FIXED),
                               params=jparams)
    te = AsyncLLMEngine(tec.EngineConfig(**common, device="cpu",
                                         **FIXED),
                        params=tparams)
    return je, te


def _both(pair, coro):
    """coro's result against the JAX server, then against the port's."""
    je, te = pair
    return [_serve(jserver.build_app(je, api_key=""), coro),
            _serve(build_app(te, api_key=""), coro)]


async def _answer(r):
    """(status, JSON body without the volatile error wording of an
    exception, Retry-After)."""
    try:
        body = await r.json()
    except Exception:
        body = await r.text()
    return r.status, body, r.headers.get("Retry-After")


# each case: the admin calls in order; the engines' catalogs end as they
# began, so the cases are independent
_ADMIN_CASES = {
    "load_then_evict": [("load", {"name": "ad-new", "src": "@ad-new"}),
                        ("evict", {"name": "ad-new"})],
    "reload_is_idempotent": [("load", {"name": "ad-one",
                                       "src": "@ad-one"})],
    "base_name_is_served": [("load", {"name": "debug-tiny",
                                      "src": "random:3"})],
    "load_without_src": [("load", {"name": "x"})],
    "load_of_a_missing_file": [("load", {"name": "x",
                                         "src": "/no/such/adapter.npz"})],
    "load_of_a_bad_body": [("load", "not json")],
    "evict_unknown": [("evict", {"name": "never-loaded"})],
    "evict_without_name": [("evict", {})],
}


@pytest.mark.parametrize("case", list(_ADMIN_CASES))
def test_admin_lora_answers_as_jax(pair, adapters, case):
    """/admin/lora/load and /admin/lora/evict: 200 with loaded true or
    false, 400 for a bad body, 503 + Retry-After (overloaded_error) for
    a failed load, 404 (not_found_error) for an unknown evict — the
    statuses and bodies of the JAX server."""
    calls = []
    for verb, body in _ADMIN_CASES[case]:
        if isinstance(body, dict) and str(body.get("src", "")).startswith(
                "@"):
            body = dict(body, src=adapters[body["src"][1:]])
        calls.append((verb, body))

    async def call(client):
        out = []
        for verb, body in calls:
            kw = ({"json": body} if isinstance(body, dict)
                  else {"data": body})
            r = await client.post(f"/admin/lora/{verb}", **kw)
            out.append(await _answer(r))
        r = await client.get("/v1/models")
        out.append([c["id"] for c in (await r.json())["data"]])
        return out

    want, got = _both(pair, call)
    assert got == want
    status = got[0][0]
    assert status == {"load_then_evict": 200, "reload_is_idempotent": 200,
                      "base_name_is_served": 200, "load_without_src": 400,
                      "load_of_a_missing_file": 503,
                      "load_of_a_bad_body": 400, "evict_unknown": 404,
                      "evict_without_name": 400}[case]
    if status == 503:
        assert got[0][2] == "5"
        assert got[0][1]["error"]["type"] == "overloaded_error"
    assert got[-1] == ["debug-tiny", "ad-one", "ad-two"]


def test_models_cards_load_and_adapter_series_equal_jax(pair):
    """/v1/models lists the base model, then each adapter with the base
    as root and parent; /load's models (read by signals.
    parse_load_report) and the tpu:engine_adapter_* series (in an
    exposition the router's parse_engine_metrics reads) equal JAX's."""
    async def call(client):
        r = await client.get("/v1/models")
        cards = [{k: c[k] for k in ("id", "root", "parent", "object")}
                 for c in (await r.json())["data"]]
        r = await client.get("/load")
        report = parse_load_report(await r.json())
        r = await client.get("/metrics")
        text = await r.text()
        parse_engine_metrics(text)
        series = {s.name: s.value
                  for f in text_string_to_metric_families(text)
                  for s in f.samples if s.name in ADAPTER_SERIES}
        return cards, list(report.models), series

    want, got = _both(pair, call)
    assert got == want
    cards, models, series = got
    assert cards[1] == {"id": "ad-one", "root": "debug-tiny",
                        "parent": "debug-tiny", "object": "model"}
    assert models == ["debug-tiny", "ad-one", "ad-two"]
    assert series["tpu:engine_adapters_loaded"] == 2.0


@pytest.mark.parametrize("path", ["/v1/embeddings", "/v1/rerank",
                                  "/v2/rerank", "/v1/score"])
@pytest.mark.parametrize("model,status", [("ad-one", 400),
                                          ("no-such-model", 404)])
def test_pooling_routes_refuse_adapters_as_jax(pair, path, model, status):
    """The pooling routes serve the base model only: an adapter answers
    400, an unknown model 404, on both servers."""
    body = ({"model": model, "input": "hello"} if path == "/v1/embeddings"
            else {"model": model, "query": "q", "documents": ["a", "b"]}
            if "rerank" in path
            else {"model": model, "text_1": "a", "text_2": ["b"]})

    async def call(client):
        r = await client.post(path, json=body)
        return r.status, (await r.json())["error"]["message"]

    want, got = _both(pair, call)
    assert got == want
    assert got[0] == status


@pytest.mark.parametrize("path", ["/v1/completions",
                                  "/v1/chat/completions"])
def test_unknown_model_answers_404_as_jax(pair, path):
    body = {"model": "sql-lora", "max_tokens": 2}
    if path == "/v1/completions":
        body["prompt"] = "x"
    else:
        body["messages"] = [{"role": "user", "content": "x"}]

    async def call(client):
        r = await client.post(path, json=body)
        return r.status, (await r.json())["error"]["message"]

    want, got = _both(pair, call)
    assert got == want
    assert got[0] == 404


def test_adapter_completions_equal_jax(pair):
    """A completion per model id, sent together: the texts equal the
    JAX server's, and the three model ids give three texts."""
    async def call(client):
        async def one(model):
            r = await client.post("/v1/completions", json={
                "model": model, "prompt": "adapters serve", "max_tokens": 8,
                "temperature": 0.0, "ignore_eos": True})
            assert r.status == 200, await r.text()
            return (await r.json())["choices"][0]["text"]
        return await asyncio.gather(*(one(m) for m in
                                      ("debug-tiny", "ad-one", "ad-two")))

    want, got = _both(pair, call)
    assert got == want
    assert len(set(got)) == 3


def test_lora_routing_through_router(pair):
    """The router, probing a port engine's /v1/models, learns its
    adapters as model ids and routes by name to distinct outputs; a
    name no backend serves answers 400 at the router."""
    from production_stack_tpu.router.app import (
        build_app as build_router_app, parse_args as router_args)
    _, te = pair

    async def body():
        engine_server = TestServer(build_app(te, api_key=""))
        await engine_server.start_server()
        url = f"http://127.0.0.1:{engine_server.port}"
        router_app = build_router_app(router_args([
            "--service-discovery", "static", "--static-backends", url,
            "--static-models", "debug-tiny", "--probe-backends"]))
        try:
            async with TestClient(TestServer(router_app)) as client:
                r = await client.get("/v1/models")
                ids = sorted(c["id"] for c in (await r.json())["data"])
                assert ids == ["ad-one", "ad-two", "debug-tiny"]

                async def ask(model):
                    r = await client.post("/v1/chat/completions", json={
                        "model": model, "max_tokens": 8,
                        "temperature": 0.0, "messages": [
                            {"role": "user", "content": "adapters"}]})
                    assert r.status == 200, await r.text()
                    return (await r.json())["choices"][0]["message"][
                        "content"]

                outs = [await ask(m) for m in
                        ("debug-tiny", "ad-one", "ad-two")]
                assert len(set(outs)) == 3
                r = await client.post("/v1/chat/completions", json={
                    "model": "no-such-adapter", "max_tokens": 4,
                    "messages": [{"role": "user", "content": "x"}]})
                assert r.status == 400
        finally:
            await engine_server.close()
    asyncio.run(body())


def test_lora_and_checkpoint_flags_reach_the_engine_config():
    args = parse_args(["--device", "cpu", "--lora-adapters",
                       "a=/x.npz,b=random:7", "--lora-rank", "16",
                       "--lora-alpha", "32", "--lora-targets", "q,k,v,o",
                       "--checkpoint", "/ckpt"])
    assert (args.lora_adapters, args.lora_rank, args.lora_alpha,
            args.lora_targets, args.checkpoint) == (
        "a=/x.npz,b=random:7", 16, 32.0, "q,k,v,o", "/ckpt")
