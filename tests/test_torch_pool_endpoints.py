"""The PyTorch port's pooling routes against the JAX package's on the
CPU: ``runner.embed`` (mean-pooled final hidden states of
``llama.encode``, the plain causal attention) against the JAX runner's
on debug-tiny and debug-gemma2 (Gemma-2's window, softcaps and sandwich
norms, an input past the sliding layers' 64-token window), and
/v1/embeddings, /v1/rerank, /v2/rerank and /v1/score against the JAX
server's replies to the same requests.

Weights are drawn once by the JAX package and carried across
(weights.params_from_jax) in float32. Vectors are held to 1e-4 of
their norm, scores to 1e-4.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import runner as jrunner
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import runner as trunner
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.server import build_app
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

from tests.torch_geometry import FIXED

TOL = 1e-4


def _weights(model, seed):
    jcfg = dataclasses.replace(jconfig.get_config(model), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config(model), dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, tcfg,
                                                   device="cpu")


@pytest.mark.parametrize("model", ["debug-tiny", "debug-gemma2"])
def test_runner_embed_equals_jax(model):
    """Four right-padded rows (100, 37, 1 and 64 tokens, two with ids
    outside the vocabulary, which take the embedding's index rule) in
    one 128-wide batch: each pooled vector is the JAX runner's to 1e-4
    of its norm, and a row alone in a narrower batch gives the same
    vector (the padding does not reach it)."""
    jcfg, tcfg, jparams, tparams = _weights(model, 21)
    common = dict(model=model, dtype="float32", kv_dtype="float32",
                  max_model_len=256, max_num_seqs=4, prefill_chunk=32,
                  prefill_buckets=(32,))
    jr = jrunner.ModelRunner(jcfg, jec.EngineConfig(**common,
                                                    window_adapt=False),
                             params=jparams)
    tr = trunner.ModelRunner(tcfg, tec.EngineConfig(**common, device="cpu"),
                             params=tparams)
    rng = np.random.default_rng(4)
    V = tcfg.vocab_size
    lengths = np.array([100, 37, 1, 64], np.int32)
    tokens = np.zeros((4, 128), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, V, n)
    tokens[1, 3], tokens[3, 0] = V + 7, -5
    want = np.asarray(jr.embed(tokens, lengths))
    got = tr.embed(tokens, lengths).numpy()
    assert got.shape == (4, tcfg.hidden_size)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL * np.linalg.norm(w)
    alone = tr.embed(tokens[1:2, :40], lengths[1:2]).numpy()[0]
    assert np.abs(alone - got[1]).max() <= TOL * np.linalg.norm(got[1])


@pytest.fixture(scope="module")
def servers():
    _, _, jparams, tparams = _weights("debug-tiny", 22)
    cfg = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
               max_model_len=128, max_num_seqs=2, prefill_chunk=32,
               prefill_buckets=(16, 32), decode_window=4)
    return (jasync.AsyncLLMEngine(jec.EngineConfig(**cfg,
                                                   **FIXED),
                                  params=jparams),
            AsyncLLMEngine(tec.EngineConfig(**cfg, device="cpu",
                                            **FIXED),
                           params=tparams))


def _both(servers, coro):
    async def run(app):
        async with TestClient(TestServer(app)) as client:
            return await coro(client)
    je, te = servers
    return (asyncio.run(run(jserver.build_app(je, api_key=""))),
            asyncio.run(run(build_app(te, api_key=""))))


_DOCS = ["Rivers run to the sea.", "The engine reads every block once.",
         "A paged pool of keys and values.", "Tea."]


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"input": ["a short one", "a somewhat longer input "
                                  "than the first", "x"]}),
    ("/v1/embeddings", {"input": [[256, 5, 6, 7], [256, 9]],
                        "model": "debug-tiny"}),
    ("/v1/rerank", {"query": "where do rivers go?", "documents": _DOCS,
                    "top_n": 3}),
    ("/v2/rerank", {"query": "pools", "documents": _DOCS}),
    ("/v1/score", {"text_1": "rivers", "text_2": _DOCS[:3]}),
    ("/v1/score", {"text_1": "rivers", "text_2": "the sea"}),
], ids=["embeddings", "embeddings-ids", "rerank", "rerank-v2", "score",
        "score-one"])
def test_pool_routes_equal_jax(servers, path, body):
    """The same JSON keys as the JAX server's reply, embedding_source
    causal-mean-pool, vectors to 1e-4 of their norm, the same order of
    documents and scores to 1e-4."""
    async def call(client):
        r = await client.post(path, json=body)
        assert r.status == 200, await r.text()
        return await r.json()
    want, got = _both(servers, call)
    assert set(got) == set(want)
    if path == "/v1/embeddings":
        assert got["embedding_source"] == want["embedding_source"] == \
            "causal-mean-pool"
        assert got["usage"] == want["usage"]
        assert len(got["data"]) == len(want["data"])
        for g, w in zip(got["data"], want["data"]):
            assert set(g) == set(w) and g["index"] == w["index"]
            gv, wv = np.array(g["embedding"]), np.array(w["embedding"])
            assert gv.shape == wv.shape == (
                tconfig.get_config("debug-tiny").hidden_size,)
            assert np.abs(gv - wv).max() <= TOL * np.linalg.norm(wv)
        return
    rows = "results" if "rerank" in path else "data"
    key = "relevance_score" if "rerank" in path else "score"
    assert [r["index"] for r in got[rows]] == \
        [r["index"] for r in want[rows]]
    np.testing.assert_allclose([r[key] for r in got[rows]],
                               [r[key] for r in want[rows]],
                               rtol=0, atol=TOL)
    assert got["usage"] == want["usage"]
    if "rerank" in path:
        assert [r["document"] for r in got[rows]] == \
            [r["document"] for r in want[rows]]


@pytest.mark.parametrize("path,body,status", [
    ("/v1/embeddings", {"input": ["fine"], "model": "other-model"}, 404),
    ("/v1/embeddings", {"input": []}, 400),
    ("/v1/embeddings", {"input": 5}, 400),
    ("/v1/embeddings", {"input": [[1] * 200]}, 400),
    ("/v1/rerank", {"query": "q", "documents": []}, 400),
    ("/v1/score", {"text_1": "a", "text_2": [1, 2]}, 400),
], ids=["unknown-model", "empty", "not-text", "too-long", "no-documents",
        "bad-text-2"])
def test_pool_route_errors_answer_as_jax(servers, path, body, status):
    async def call(client):
        r = await client.post(path, json=body)
        return r.status
    assert _both(servers, call) == (status, status)
