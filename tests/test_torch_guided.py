"""The PyTorch port's guided decoding against the JAX package's on the
CPU: the port's copy of engine/guided.py lifts the same token tables,
greedy guided rows (alone, and beside plain and shaped rows, with and
without preemption) emit the JAX engine's tokens, sampled guided rows
match their pattern, and the server answers guided_regex,
guided_choice, guided_json and response_format with the JAX server's
status codes.

Engines compare in float32 on weights drawn once by the JAX package
and carried across (weights.params_from_jax); debug-tiny's byte
tokenizer makes every byte a token, so the DFA's byte and token walks
coincide.
"""

import asyncio
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import guided as jguided
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.engine.tokenizer import (
    load_tokenizer as jload_tokenizer)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import guided
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app
from production_stack_tpu_torch.engine.tokenizer import load_tokenizer
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

from tests.torch_geometry import FIXED

_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "n": {"type": "integer"}}}
# a two-key object whose every path ends: greedy decoding of an integer
# can repeat a digit until the token budget runs out
_BOUNDED = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "tag": {"enum": ["x", "y"]}}}

_F32 = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
            max_model_len=128, max_num_seqs=3, prefill_chunk=32,
            prefill_buckets=(16, 32), decode_window=4, kv_block_size=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(12))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(np_params, tcfg, device="cpu")


def _engines(weights, **kw):
    jparams, tparams = weights
    cfg = dict(_F32, **kw)
    return (jengine.LLMEngine(jec.EngineConfig(**cfg, window_adapt=False,
                                               pipeline_depth=1),
                              params=jparams),
            tengine.LLMEngine(tec.EngineConfig(**cfg, device="cpu",
                                               **FIXED),
                              params=tparams))


def _run(engine, opts_cls, prompts, rows):
    ids = [engine.add_request(list(p), opts_cls(**kw))
           for p, kw in zip(prompts, rows)]
    while engine.has_work:
        engine.step()
    return [engine.seqs[i] for i in ids]


@pytest.mark.parametrize("pattern", [
    guided.choice_regex(["red", "green", "blue"]),
    r"\d{3}",
    guided.json_schema_regex(_SCHEMA),
], ids=["choice", "digits", "json"])
def test_compiled_tables_equal_jax(pattern):
    """The port's compile_grammar lifts the JAX module's token table,
    element for element, on the byte tokenizer; the schema and choice
    regexes are the JAX module's too."""
    assert guided.choice_regex(["a.b", "c|d"]) == \
        jguided.choice_regex(["a.b", "c|d"])
    assert guided.json_schema_regex(_SCHEMA) == \
        jguided.json_schema_regex(_SCHEMA)
    got = guided.compile_grammar(pattern, load_tokenizer("debug-tiny"))
    want = jguided.compile_grammar(pattern, jload_tokenizer("debug-tiny"))
    assert got.n_states == want.n_states
    np.testing.assert_array_equal(got.token_next, want.token_next)


_ROWS = [
    dict(guided_regex=r"(red|green|blue)!"),
    dict(ignore_eos=True),
    dict(guided_regex=r"\d{3}-\d{2}", presence_penalty=1.0, top_logprobs=3),
    dict(guided_regex=guided.json_schema_regex(_BOUNDED)),
    dict(repetition_penalty=1.3, frequency_penalty=0.5, ignore_eos=True),
]


@pytest.mark.parametrize("pool", [None, 1], ids=["pool", "preempting"])
def test_engine_greedy_guided_rows_equal_jax(weights, pool):
    """Five greedy rows in three slots: guided rows (a choice, digits
    that are also shaped and ask for alternatives, a JSON schema)
    beside a plain and a shaped row, sharing windows; with the smallest
    pool (one full-length sequence, 128 tokens) the youngest are
    preempted and resume from their DFA state. Tokens and finish
    reasons equal the JAX engine's, logprobs to 1e-5; every guided
    output fully matches its pattern."""
    lead = b"Answer the question below in one go. "
    prompts = [[256] + list(lead + p) for p in (
        b"colour?", b"plain text", b"number:", b"json:", b"shaped")]
    rows = [dict(temperature=0.0, max_tokens=40, **r) for r in _ROWS]
    je, te = _engines(weights, kv_pool_tokens=pool)
    want = _run(je, JSamplingOptions, prompts, rows)
    got = _run(te, SamplingOptions, prompts, rows)
    for g, w, row in zip(got, want, rows):
        assert (g.output_tokens, g.finish_reason) == \
            (w.output_tokens, w.finish_reason)
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   rtol=0, atol=1e-5)
        if row.get("guided_regex"):
            assert g.finish_reason == "stop"
            assert re.fullmatch(row["guided_regex"], g.output_text), \
                g.output_text
    doc = json.loads(got[3].output_text)
    assert set(doc) == {"ok", "tag"}
    if pool is not None:
        assert te.metrics.preemptions._value.get() > 0


@pytest.mark.parametrize("pattern,check", [
    (r"(red|green|blue)", None),
    (r"\d{3}", None),
    (guided.json_schema_regex(_SCHEMA), "json"),
], ids=["regex", "digits", "json"])
def test_engine_sampled_guided_rows_match(weights, pattern, check):
    """Rows sampled at temperature 1.0 (two seeded, one not) beside an
    unguided sampled row: every guided output fully matches its pattern
    and ends on EOS."""
    _, te = _engines(weights)
    rows = [dict(temperature=1.0, max_tokens=60, guided_regex=pattern,
                 seed=s) for s in (1, 2, None)]
    rows.append(dict(temperature=1.0, max_tokens=6, ignore_eos=True))
    seqs = _run(te, SamplingOptions, [[256, 1, 2, 3]] * 4, rows)
    for seq in seqs[:3]:
        assert seq.finish_reason == "stop"
        assert re.fullmatch(pattern, seq.output_text), seq.output_text
        if check == "json":
            assert set(json.loads(seq.output_text)) == {"ok", "n"}
    assert len(seqs[3].output_tokens) == 6


def test_guided_table_rebuilds_only_when_patterns_change(weights):
    """The stacked table is built for the active patterns and kept while
    they stay; row 0 is the unguided placeholder and a pattern's row is
    its compiled table."""
    _, te = _engines(weights)
    tok = te.tokenizer
    a = te.add_request([256, 1], SamplingOptions(
        temperature=0.0, max_tokens=30, guided_regex=r"\d{3}"))
    te.step()
    table = te._guided_table
    assert table is not None and te._guided_key == (r"\d{3}",)
    g = guided.compile_grammar(r"\d{3}", tok)
    row = te._guided_gids[r"\d{3}"]
    assert (table[0] == -1).all()
    np.testing.assert_array_equal(
        table[row, :g.n_states].numpy(), g.token_next)
    te.step()
    assert te._guided_table is table
    while te.has_work:
        te.step()
    assert re.fullmatch(r"\d{3}", te.seqs[a].output_text)


# ------------------------------------------------------------------ server

def _serve(app, coro):
    async def runner():
        async with TestClient(TestServer(app)) as client:
            return await coro(client)
    return asyncio.run(runner())


@pytest.fixture(scope="module")
def servers(weights):
    jparams, tparams = weights
    cfg = dict(_F32, max_num_seqs=2)
    return (jasync.AsyncLLMEngine(jec.EngineConfig(**cfg,
                                                   **FIXED),
                                  params=jparams),
            AsyncLLMEngine(tec.EngineConfig(**cfg, device="cpu",
                                            **FIXED),
                           params=tparams))


def _chat(extra, max_tokens=40):
    return {"model": "debug-tiny", "max_tokens": max_tokens,
            "temperature": 0.0,
            "messages": [{"role": "user", "content": "answer:"}], **extra}


@pytest.mark.parametrize("path,body,status", [
    ("/v1/chat/completions",
     _chat({"guided_choice": ["yes", "no", "maybe"]}), 200),
    ("/v1/chat/completions", _chat({"guided_json": {
        "type": "object", "properties": {"tag": {"enum": ["x", "y"]}}}}),
     200),
    ("/v1/chat/completions", _chat({"response_format": {
        "type": "json_schema", "json_schema": {"name": "s",
                                               "schema": _SCHEMA}}}), 200),
    ("/v1/completions", {"model": "debug-tiny", "prompt": "code:",
                         "max_tokens": 12, "temperature": 0.0,
                         "guided_regex": r"[A-F]{4}"}, 200),
    ("/v1/chat/completions",
     _chat({"response_format": {"type": "json_object"}}), 400),
    ("/v1/chat/completions", _chat({"guided_json": {"type": "object"}}),
     400),
    ("/v1/completions", {"model": "debug-tiny", "prompt": "x",
                         "guided_regex": "(ab"}, 400),
    ("/v1/chat/completions",
     _chat({"response_format": {"type": "yaml"}}), 400),
], ids=["choice", "json", "response-format-schema", "regex",
        "json-object", "free-form-schema", "bad-regex", "unknown-format"])
def test_server_guided_fields_answer_as_jax(servers, path, body, status):
    """The JAX server's status for each guided field; a 200 gives the
    JAX server's text (greedy), which matches the constraint."""
    async def call(client):
        r = await client.post(path, json=body)
        return r.status, await r.json()
    je, te = servers
    (ws, want), (gs, got) = (_serve(jserver.build_app(je, api_key=""), call),
                             _serve(build_app(te, api_key=""), call))
    assert gs == ws == status, got
    if status != 200:
        return
    key = "message" if "messages" in body else "text"

    def text(resp):
        c = resp["choices"][0]
        return c["message"]["content"] if key == "message" else c["text"]
    assert text(got) == text(want)
    if "guided_choice" in body:
        assert text(got) in body["guided_choice"]
    elif "guided_regex" in body:
        assert re.fullmatch(body["guided_regex"], text(got))
    else:
        json.loads(text(got))


def test_server_guided_top_logprobs_have_no_minus_infinity(servers):
    """A guided row asking for alternatives: the forbidden tokens'
    -inf entries are dropped, so the JSON holds finite values only and
    the chosen token leads."""
    _, te = servers

    async def call(client):
        r = await client.post("/v1/chat/completions", json=_chat(
            {"guided_choice": ["alpha", "beta"], "logprobs": True,
             "top_logprobs": 5}))
        assert r.status == 200
        return json.loads(await r.text())
    out = _serve(build_app(te, api_key=""), call)
    content = out["choices"][0]["logprobs"]["content"]
    assert content
    for e in content:
        tops = [t["logprob"] for t in e["top_logprobs"]]
        assert tops and all(np.isfinite(tops))
        assert abs(tops[0] - e["logprob"]) < 1e-6
