"""Disaggregated prefill through the JAX router and through the port's
with port engines: the setup of
tests/test_disagg.py::test_disagg_prefill_stack_end_to_end, the router's
prefill stage (``--prefill-backends``) on a port kv_producer server and
its decode stage on a port kv_consumer server, joined by a shared disk
tier. The consumer serves the chat from the producer's
chunks (hit tokens > 0) and its text equals a fresh port engine's.

float32 weights and pool: the consumer prefills only the suffix past the
cached chunks, so its rows run in other batch shapes than the fresh
engine's whole-prompt chunks, which bf16 rounding could turn into a
different greedy token at a near-tie.
"""

import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.router import app as jax_router
from production_stack_tpu_torch.router import app as port_router
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.server import build_app

LONG_PROMPT = ("Summarize the following report. " * 12).strip()


def _config(kv=None):
    return EngineConfig(
        model="debug-tiny", device="cpu", dtype="float32",
        kv_dtype="float32", max_model_len=512, max_num_seqs=2,
        prefill_chunk=64, prefill_buckets=(16, 32, 64, 128, 256),
        kv_transfer_config=kv)


@pytest.mark.parametrize("router", [jax_router, port_router],
                         ids=["jax", "port"])
def test_jax_router_disagg_stage_serves_port_engines(tmp_path, router):
    tier = {"chunk_size": 32, "local_disk_path": str(tmp_path / "tier")}
    producer = AsyncLLMEngine(_config(dict(tier, kv_role="kv_producer")))
    consumer = AsyncLLMEngine(_config(dict(tier, kv_role="kv_consumer")))
    fresh = AsyncLLMEngine(_config())
    req = {"model": "debug-tiny",
           "messages": [{"role": "user", "content": LONG_PROMPT}],
           "max_tokens": 8, "temperature": 0.0}

    async def body():
        servers = [TestServer(build_app(e, api_key=""))
                   for e in (producer, consumer)]
        for srv in servers:
            await srv.start_server()
        args = router.parse_args([
            "--service-discovery", "static",
            "--static-backends", f"http://127.0.0.1:{servers[1].port}",
            "--static-models", "debug-tiny",
            "--prefill-backends", f"http://127.0.0.1:{servers[0].port}",
            "--prefill-models", "debug-tiny"])
        app = router.build_app(args)
        try:
            async with TestClient(TestServer(app)) as client:
                r = await client.post("/v1/chat/completions", json=req)
                assert r.status == 200, await r.text()
                out = await r.json()
                orch = app["state"]["disagg"]
                assert (orch.prefills, orch.prefill_errors) == (1, 0)
                p_load = await (await client.session.get(
                    f"http://127.0.0.1:{servers[0].port}/load")).json()
                c_load = await (await client.session.get(
                    f"http://127.0.0.1:{servers[1].port}/load")).json()
            async with TestClient(TestServer(
                    build_app(fresh, api_key=""))) as fc:
                r = await fc.post("/v1/chat/completions", json=req)
                assert r.status == 200
                want = await r.json()
        finally:
            for srv in servers:
                await srv.close()
        return out, want, p_load, c_load

    out, want, p_load, c_load = asyncio.run(body())
    assert p_load["kv_cache"]["role"] == "kv_producer"
    assert p_load["kv_cache"]["published_chunks"] > 0
    assert c_load["kv_cache"]["role"] == "kv_consumer"
    assert c_load["kv_cache"]["hit_tokens"] > 0, \
        "the decode engine recomputed the prompt"
    assert consumer.engine.connector.hit_tokens > 0
    assert out["choices"][0]["message"]["content"] == \
        want["choices"][0]["message"]["content"]
