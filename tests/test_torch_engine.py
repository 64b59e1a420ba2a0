"""The PyTorch port's serving path against the JAX package's on the CPU:
sampler contracts, the ModelRunner, the LLMEngine, the HTTP server, the
options the port refuses, and the port's import isolation.

Engines compare in float32 weights and KV (so argmax ties cannot flip
between two libraries' summation orders) on weights drawn once by the
JAX package and carried across (weights.params_from_jax). Greedy ids
must match exactly; logprobs to 1e-4 (float32 log_softmax over logits
that agree to 1e-4, tests/test_torch_model.py).
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import runner as jrunner
from production_stack_tpu.engine import sampler as jsampler
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import runner as trunner
from production_stack_tpu_torch.engine import sampler as tsampler
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import quant as tquant
from production_stack_tpu_torch.weights import cache_from_jax, params_from_jax

from tests.torch_geometry import FIXED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- sampler

def _logits(seed, B=4, V=64):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


def test_sample_greedy_is_exact_argmax_as_in_jax():
    lg = _logits(0)
    B = lg.shape[0]
    got = tsampler.sample(torch.from_numpy(lg),
                          tsampler.SamplingParams.filled(B, temperature=0.0,
                                                        device="cpu"),
                          torch.Generator().manual_seed(0))
    want = jsampler.sample(jnp.asarray(lg),
                           jsampler.SamplingParams.filled(B,
                                                          temperature=0.0),
                           jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), lg.argmax(-1))


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(temperature=1e-7),
                                dict(top_p=1e-6), dict(min_p=1.0)])
def test_sample_degenerate_truncations_equal_greedy(kw):
    lg = _logits(1)
    B = lg.shape[0]
    params = tsampler.SamplingParams.filled(B, **kw, device="cpu")
    for seed in range(3):
        got = tsampler.sample(torch.from_numpy(lg), params,
                              torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got.numpy(), lg.argmax(-1))


def test_seeded_rows_reproduce_whatever_the_batch():
    """The same (seed, position) gives the same token in any batch and
    whatever the engine generator's state: the contract the JAX
    package's threefry rows keep, with other noise."""
    V = 64
    lg = _logits(2, B=5, V=V)
    row = lg[3:4]

    def run(logits, seeds, positions, gen_seed):
        B = logits.shape[0]
        p = tsampler.SamplingParams.filled(B, temperature=1.0, device="cpu")
        p.seed = torch.tensor(seeds, dtype=torch.int64)
        return tsampler.sample(torch.from_numpy(logits), p,
                               torch.Generator().manual_seed(gen_seed),
                               positions=torch.tensor(positions))

    alone = [run(row, [7], [11], g).item() for g in range(4)]
    assert len(set(alone)) == 1
    batched = run(lg, [0, 3, 0, 7, 9], [5, 6, 7, 11, 2], gen_seed=99)
    assert batched[3].item() == alone[0]
    # the noise varies with seed and position
    draws = {run(row, [s], [p], 0).item() for s in range(1, 9)
             for p in range(4)}
    assert len(draws) > 1


# ---------------------------------------------------------- runner/engine

def _weights(seed=0, model="debug-tiny"):
    jcfg = dataclasses.replace(jconfig.get_config(model),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config(model),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, tcfg,
                                                   device="cpu")


_F32 = dict(model="debug-tiny", dtype="float32", kv_dtype="float32")


def test_runner_prefill_and_decode_windows_match_jax():
    jcfg, tcfg, jparams, tparams = _weights(1)
    common = dict(_F32, max_model_len=64, max_num_seqs=3, prefill_chunk=16,
                  prefill_buckets=(16,), decode_window=4, kv_block_size=8)
    jr = jrunner.ModelRunner(jcfg, jec.EngineConfig(**common,
                                                    window_adapt=False),
                             params=jparams)
    tr = trunner.ModelRunner(tcfg, tec.EngineConfig(**common, device="cpu"),
                             params=tparams)
    B, S, kv = 3, 64, 64
    rng = np.random.default_rng(5)
    tables = (rng.permutation(B * 8) + 1).reshape(B, 8).astype(np.int32)
    for r in (jr, tr):
        r.set_block_tables(tables)
    tokens = rng.integers(0, 512, (B, 16)).astype(np.int32)
    starts = np.array([0, 0, S], np.int32)            # row 2 parked
    lengths = np.array([16, 9, 1], np.int32)
    jids, jlps, _ = jr.prefill(tokens, starts, lengths,
                            jsampler.SamplingParams.filled(
                                B, temperature=0.0), kv)
    tids, tlps, _ = tr.prefill(tokens, starts, lengths,
                            tsampler.SamplingParams.filled(
                                B, temperature=0.0, device="cpu"), kv,
                            greedy=True)
    np.testing.assert_array_equal(tids.numpy()[:2], np.asarray(jids)[:2])
    np.testing.assert_allclose(tlps.numpy()[:2], np.asarray(jlps)[:2],
                               rtol=0, atol=1e-4)
    first = np.asarray(jids)
    positions = np.where(starts < S, lengths, S).astype(np.int32)
    for r in (jr, tr):
        r.set_decode_state(first, positions)
    for _ in range(3):
        jw, jl, _, _ = jr.decode(
            jsampler.SamplingParams.filled(B, temperature=0.0), steps=4,
            kv_len=kv, greedy=True)
        tw, tl, _ = tr.decode(tsampler.SamplingParams.filled(
            B, temperature=0.0, device="cpu"), steps=4, kv_len=kv,
            greedy=True)
        np.testing.assert_array_equal(tw.numpy()[:2], np.asarray(jw)[:2])
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("prefix_caching", [False, True])
def test_engine_greedy_tokens_equal_jax_engine_mixed_batch(prefix_caching):
    """Five prompts of mixed lengths (two span several prefill chunks,
    the last repeats the second's first 33 tokens) through three slots:
    admission waits, chunked prefill interleaved with decode windows,
    ragged budgets, and with prefix caching a shared-block admission.
    Greedy tokens equal the JAX engine's, sequence by sequence."""
    _, _, jparams, tparams = _weights(2)
    common = dict(_F32, max_model_len=128, max_num_seqs=3,
                  prefill_chunk=32, prefill_buckets=(16, 32),
                  decode_window=4, kv_block_size=8,
                  enable_prefix_caching=prefix_caching)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 70, 12)]
    prompts.append(prompts[1][:33] + [7, 7])
    budgets = (10, 6, 12, 20, 8)

    def run(engine, opts_cls):
        ids = [engine.add_request(p, opts_cls(temperature=0.0,
                                              max_tokens=m,
                                              ignore_eos=True))
               for p, m in zip(prompts, budgets)]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]

    want = run(je, JSamplingOptions)
    got = run(te, SamplingOptions)
    assert [len(t) for t in got] == list(budgets)
    assert got == want


def test_engine_greedy_tokens_equal_jax_engine_gemma2():
    """debug-gemma2 through both engines with the configuration of
    tests/test_gemma2.py::test_engine_e2e_gemma2 (in float32): a
    100-token prompt past the 64-token window on the sliding layer, then
    24 greedy tokens, next to a short prompt. The tokens equal the JAX
    engine's."""
    _, _, jparams, tparams = _weights(4, model="debug-gemma2")
    common = dict(model="debug-gemma2", dtype="float32", kv_dtype="float32",
                  max_model_len=256, max_num_seqs=2, prefill_chunk=32,
                  prefill_buckets=(32,), decode_window=4)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    prompts = [list(range(3, 103)), list(range(7, 20))]

    def run(engine, opts_cls):
        ids = [engine.add_request(p, opts_cls(temperature=0.0,
                                              max_tokens=24,
                                              ignore_eos=True))
               for p in prompts]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]

    want = run(je, JSamplingOptions)
    got = run(te, SamplingOptions)
    assert [len(t) for t in got] == [24, 24]
    assert got == want


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_out_of_vocab_prompt_ids_follow_jax_and_engine_serves_on(
        quantization):
    """Prompt ids outside the vocabulary (600 and -600 against V = 512,
    and ids below -V) take the JAX gather's index rule in the embedding,
    on a float and an int8 table: the greedy tokens equal the JAX
    engine's, and the engine serves the next request."""
    _, _, jparams, tparams = _weights(7)
    common = dict(_F32, max_model_len=64, max_num_seqs=2, prefill_chunk=16,
                  prefill_buckets=(16,), decode_window=4, kv_block_size=8,
                  quantization=quantization)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    prompts = [[1, 600, 3], [1, 600, -600, -2000, 511, 3], [5, 6, 7]]

    def run(engine, opts_cls):
        out = []
        for p in prompts:
            sid = engine.add_request(p, opts_cls(temperature=0.0,
                                                 max_tokens=6,
                                                 ignore_eos=True))
            while engine.has_work:
                engine.step()
            out.append(engine.seqs[sid].output_tokens)
        return out

    want = run(je, JSamplingOptions)
    got = run(te, SamplingOptions)
    assert [len(t) for t in got] == [6, 6, 6]
    assert got == want


def test_prefix_keys_and_fingerprint_match_jax():
    """Prefix-cache keys are the JAX package's, byte for byte, so KV
    chunks keyed by one package are found by the other."""
    from production_stack_tpu.engine.block_manager import (
        BlockManager as JBlockManager)
    from production_stack_tpu.kvcache.chunks import (
        model_fingerprint as jfingerprint)
    from production_stack_tpu_torch.engine.block_manager import (
        BlockManager, model_fingerprint)
    for name in ("debug-tiny", "llama-3-8b"):
        assert model_fingerprint(tconfig.get_config(name), "bfloat16") == \
            jfingerprint(jconfig.get_config(name), "bfloat16")
    toks = list(range(100, 170))
    ns = model_fingerprint(tconfig.get_config("debug-tiny"))
    assert BlockManager(16, 8, True, ns).prefix_keys(toks) == \
        JBlockManager(16, 8, True, ns).prefix_keys(toks)


def test_engine_refuses_unported_options():
    """A model id the engine does not serve (no adapter of that name) is
    refused as unknown, as in the JAX engine; the shaping, logprob and
    guided options the port implements are taken, and a guided pattern
    the regex compiler cannot parse is a ValueError at add_request, as
    in the JAX engine."""
    te = tengine.LLMEngine(tec.EngineConfig(
        model="debug-tiny", device="cpu", max_model_len=64, max_num_seqs=1,
        prefill_chunk=16, prefill_buckets=(16,)))
    with pytest.raises(ValueError, match="unknown model"):
        te.add_request([1, 2], SamplingOptions(), model="my-adapter")
    with pytest.raises(ValueError):
        te.add_request([1, 2, 3], SamplingOptions(guided_regex="(a+"))
    for kw in (dict(presence_penalty=0.5), dict(logit_bias={1: 2.0}),
               dict(top_logprobs=2), dict(min_tokens=3),
               dict(repetition_penalty=1.2), dict(guided_regex="a+")):
        te.add_request([1, 2, 3], SamplingOptions(**kw))


@pytest.mark.parametrize("kw", [
    dict(pipeline_parallel_size=2), dict(window_adapt=True),
    dict(pipeline_depth=2),
    dict(expert_parallel_size=2, tensor_parallel_size=2,
         window_adapt=True)])
def test_engine_config_pins_unported_options(kw):
    """Pipeline-parallel serving is refused as in JAX; adaptive windows
    and pipelined windows are ported (JAX's defaults), with JAX's
    derived batch and window buckets."""
    if "pipeline_parallel_size" in kw:
        with pytest.raises(NotImplementedError):
            tec.EngineConfig(model="debug-tiny", device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            jec.EngineConfig(model="debug-tiny", **kw)
        return
    got = tec.EngineConfig(model="debug-tiny", device="cpu", **kw)
    want = jec.EngineConfig(model="debug-tiny", **kw)
    assert got.window_adapt and got.pipeline_depth == 2
    assert got.decode_batch_buckets == want.decode_batch_buckets \
        == (1, 2, 4, 8)
    assert got.decode_window_buckets == want.decode_window_buckets


def test_engine_config_takes_embedding_model():
    """The encoder is ported: the config takes embedding_model, and a
    name that is neither a preset nor a directory fails at engine start
    with the JAX engine's ValueError."""
    cfg = tec.EngineConfig(model="debug-tiny", device="cpu",
                           max_model_len=64, max_num_seqs=1,
                           embedding_model="bge-small")
    assert cfg.embedding_model == "bge-small"
    with pytest.raises(ValueError, match="unknown encoder preset"):
        tengine.LLMEngine(cfg)
    with pytest.raises(ValueError, match="unknown encoder preset"):
        jengine.LLMEngine(jec.EngineConfig(
            model="debug-tiny", max_model_len=64, max_num_seqs=1,
            embedding_model="bge-small"))


def test_engine_config_accepts_kv_transfer_config():
    """KV tiering is ported: the config takes kv_transfer_config, and an
    engine given one without any tier raises the JAX connector's
    ValueError instead of serving without the tiers it asked for."""
    cfg = tec.EngineConfig(model="debug-tiny", device="cpu",
                           max_model_len=64, max_num_seqs=1,
                           kv_transfer_config={"kv_role": "kv_both"})
    assert cfg.kv_transfer_config == {"kv_role": "kv_both"}
    with pytest.raises(ValueError, match="no tier configured"):
        tengine.LLMEngine(cfg)


@pytest.mark.parametrize("kw", [dict(quantization="int8"),
                                dict(kv_dtype="int8")])
def test_engine_config_accepts_int8_options(kw):
    """Weight-only int8 and the int8 KV pool are ported: the config takes
    them, and the runner quantizes the weights or allocates the int8
    pool with its scales."""
    cfg = tec.EngineConfig(model="debug-tiny", device="cpu",
                           max_model_len=64, max_num_seqs=1, **kw)
    runner = trunner.ModelRunner(tconfig.get_config("debug-tiny"), cfg)
    assert tquant.is_quantized(runner.params.q) == ("quantization" in kw)
    assert runner.cache.quantized == ("kv_dtype" in kw)


def test_engine_config_without_device_needs_cuda():
    """The entry points run on the card unless the caller asks for the
    CPU: with no CUDA they raise rather than drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tec.EngineConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tec.EngineConfig(model="debug-tiny", device="cuda:0")


@pytest.mark.parametrize("build", [
    lambda: tllama.Llama(tconfig.get_config("debug-tiny")),
    lambda: tllama.init_params(tconfig.get_config("debug-tiny"),
                               torch.Generator()),
    lambda: tkv.make_cache(1, 2, 8, 1, 8),
    lambda: tkv.make_cache(1, 2, 8, 1, 8, dtype=torch.int8),
    lambda: tkv.linear_tables(2, 16, 8),
    lambda: tkv.make_slot_cache(1, 2, 16, 1, 8),
    lambda: params_from_jax({}, tconfig.get_config("debug-tiny")),
    lambda: cache_from_jax(np.zeros((1, 2, 1, 8, 8), np.float32),
                           np.zeros((1, 2, 1, 8, 8), np.float32)),
    lambda: tsampler.SamplingParams.filled(2),
], ids=["Llama", "init_params", "make_cache", "make_cache_int8",
        "linear_tables", "make_slot_cache", "params_from_jax",
        "cache_from_jax", "SamplingParams.filled"])
def test_library_defaults_to_cuda(build):
    """The library's constructors default to the card as the engine
    does: with no CUDA they raise rather than build on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


# ----------------------------------------------------------------- server

_SERVER_CFG = dict(model="debug-tiny", device="cpu", max_model_len=128,
                   max_num_seqs=2, prefill_chunk=32,
                   prefill_buckets=(16, 32), decode_window=4)


def _with_client(engine, coro):
    async def runner():
        async with TestClient(TestServer(
                build_app(engine, api_key=""))) as client:
            return await coro(client)
    return asyncio.run(runner())


@pytest.fixture(scope="module")
def engine():
    eng = AsyncLLMEngine(tec.EngineConfig(**_SERVER_CFG))
    eng.engine.runner.warmup()
    return eng


def test_server_smoke(engine):
    async def body(client):
        r = await client.get("/health")
        assert r.status == 200
        r = await client.get("/v1/models")
        assert (await r.json())["data"][0]["id"] == "debug-tiny"
        # a completion whose prompt spans two prefill chunks
        prompt = "the quick brown fox jumps over the lazy dog " * 2
        payload = {"model": "debug-tiny", "prompt": prompt,
                   "max_tokens": 6, "temperature": 0.0,
                   "ignore_eos": True, "logprobs": 0}
        r1, r2 = await asyncio.gather(
            client.post("/v1/completions", json=payload),
            client.post("/v1/chat/completions", json={
                "model": "debug-tiny", "max_tokens": 5, "ignore_eos": True,
                "messages": [{"role": "user", "content": "hello"}]}))
        assert (r1.status, r2.status) == (200, 200)
        d1, d2 = await r1.json(), await r2.json()
        assert d1["usage"]["completion_tokens"] == 6
        assert d1["choices"][0]["finish_reason"] == "length"
        assert len(d1["choices"][0]["logprobs"]["token_logprobs"]) == 6
        assert d2["object"] == "chat.completion"
        assert d2["usage"]["completion_tokens"] == 5
        # greedy twice: the same text
        r3 = await client.post("/v1/completions", json=payload)
        assert (await r3.json())["choices"][0]["text"] == \
            d1["choices"][0]["text"]
        r = await client.post("/v1/chat/completions", json={
            "model": "debug-tiny", "max_tokens": 4, "stream": True,
            "ignore_eos": True, "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": "hi"}]})
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = [ln[len("data: "):] for ln in
                  (await r.read()).decode().splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == 4
    _with_client(engine, body)


def _payload(path, extra):
    payload = {"model": "debug-tiny", "max_tokens": 2}
    if path == "/v1/chat/completions":
        payload["messages"] = [{"role": "user", "content": "x"}]
    else:
        payload["prompt"] = "x"
    payload.update(extra)
    return payload


# a model field that is not a model name, and guided constraints the port
# cannot take (a pattern that does not parse, a choice that is not a
# string, a free-form JSON object): 400, naming the field. (A model name
# that is not served answers 404, as in the JAX server:
# tests/test_torch_lora_server.py.)
@pytest.mark.parametrize("path,extra,field", [
    ("/v1/chat/completions", {"guided_regex": "(a+"}, "guided_regex"),
    ("/v1/chat/completions", {"guided_choice": ["a", 5]},
     "guided_choice"),
    ("/v1/chat/completions", {"model": ["sql-lora"]}, "model"),
    ("/v1/chat/completions", {"response_format": {"type": "json_object"}},
     "response_format"),
])
def test_server_unported_fields_answer_400(engine, path, extra, field):
    async def body(client):
        r = await client.post(path, json=_payload(path, extra))
        assert r.status == 400
        assert field in (await r.json())["error"]["message"]
    _with_client(engine, body)


@pytest.mark.parametrize("path,extra,choices", [
    ("/v1/chat/completions", {"presence_penalty": 0.5}, 1),
    ("/v1/chat/completions", {"frequency_penalty": 0.5}, 1),
    ("/v1/chat/completions", {"logit_bias": {"5": 1.0}}, 1),
    ("/v1/chat/completions", {"logprobs": True, "top_logprobs": 2}, 1),
    ("/v1/chat/completions", {"n": 2}, 2),
    ("/v1/completions", {"logprobs": 3}, 1),
    ("/v1/completions", {"echo": True, "logprobs": 0}, 1),
    ("/v1/completions", {"min_tokens": 2}, 1),
    ("/v1/completions", {"prompt": ["a", "b"]}, 2),
])
def test_server_formerly_refused_fields_answer_200(engine, path, extra,
                                                   choices):
    """The options the port refused until it implemented them are
    served: 200, with one choice per (prompt, n)."""
    async def body(client):
        r = await client.post(path, json=_payload(path, extra))
        assert r.status == 200, await r.text()
        out = await r.json()
        assert [c["index"] for c in out["choices"]] == list(range(choices))
    _with_client(engine, body)


def test_failed_step_fails_requests_and_stops_the_loop():
    """A step that raises is not logged and retried: the in-flight
    request gets a 500, /health turns 503 and the loop ends."""
    eng = AsyncLLMEngine(tec.EngineConfig(**_SERVER_CFG))

    def broken(*a, **k):
        raise RuntimeError("device fault")
    eng.engine.runner.decode = broken

    async def body(client):
        payload = {"model": "debug-tiny", "prompt": "hello",
                   "max_tokens": 4}
        r = await client.post("/v1/completions", json=payload)
        assert r.status == 500
        assert "device fault" in (await r.json())["error"]["message"]
        assert (await client.get("/health")).status == 503
        r = await client.post("/v1/completions", json=payload)
        assert r.status == 500
        # the loop hands the failure to the event loop, then returns
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()
    _with_client(eng, body)


# -------------------------------------------------------- import isolation

def test_port_imports_neither_jax_nor_the_jax_package():
    """The port's server and its training path (parallel/train.py,
    ring_attention.py, pipeline.py, dryrun.py) import with jax, optax and
    production_stack_tpu blocked (a subprocess: this one has them
    loaded), and with them
    safetensors, transformers and peft, which the card does not have:
    guided decoding (engine/guided.py), the pooling path (encode,
    causal_attention, the routes), multi-LoRA (models/lora.py) and the
    checkpoint loader (models/hf_loader.py, whose own reader then reads
    back a file its writer wrote) included; and with ml_dtypes blocked
    too, the KV-tier modules (kvcache/), whose codecs then encode and
    decode bf16-free f32 bodies through every codec, fp8 included."""
    code = textwrap.dedent("""
        import sys
        import tempfile

        ROOTS = ("jax", "optax", "production_stack_tpu", "safetensors",
                 "transformers", "peft", "ml_dtypes")

        def blocked(name):
            return any(name == r or name.startswith(r + ".")
                       for r in ROOTS)

        class Block:
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import production_stack_tpu_torch.engine.server
        import production_stack_tpu_torch.weights
        import production_stack_tpu_torch.kernels
        import production_stack_tpu_torch.ops.flash_attention
        import production_stack_tpu_torch.models.quant
        import production_stack_tpu_torch.tracing
        import production_stack_tpu_torch.version
        import production_stack_tpu_torch.engine.efficiency
        import production_stack_tpu_torch.engine.metrics
        import production_stack_tpu_torch.engine.guided
        import production_stack_tpu_torch.engine.runner
        import production_stack_tpu_torch.models.lora
        import production_stack_tpu_torch.models.hf_loader
        import production_stack_tpu_torch.parallel.mesh
        import production_stack_tpu_torch.parallel.sharding
        import production_stack_tpu_torch.parallel.workers
        import production_stack_tpu_torch.parallel.train
        import production_stack_tpu_torch.parallel.ring_attention
        import production_stack_tpu_torch.parallel.pipeline
        import production_stack_tpu_torch.parallel.dryrun
        import production_stack_tpu_torch.models.encoder
        import production_stack_tpu_torch.kvcache
        import production_stack_tpu_torch.kvcache.chunks
        import production_stack_tpu_torch.kvcache.codec
        import production_stack_tpu_torch.kvcache.connector
        import production_stack_tpu_torch.kvcache.pipeline
        import production_stack_tpu_torch.kvcache.protocol
        import production_stack_tpu_torch.kvcache.server
        import production_stack_tpu_torch.kvcache.store
        import production_stack_tpu_torch.kvcache._native
        from production_stack_tpu_torch.models.llama import encode
        from production_stack_tpu_torch.ops.attention import (
            causal_attention)
        from production_stack_tpu_torch.engine.server import (
            embeddings, rerank, score)
        import torch
        from production_stack_tpu_torch.models import hf_loader
        with tempfile.TemporaryDirectory() as d:
            t = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
            hf_loader.save_safetensors(t, d + "/m.safetensors")
            assert torch.equal(hf_loader.read_state_dict(d)["w"], t["w"])
        # the fp8 and bf16 tier codecs without ml_dtypes
        import numpy as np
        from production_stack_tpu_torch.kvcache import codec
        body = np.array([1.5, -465.0, 0.25, 3.0], np.float32).tobytes()
        for name in ("fp8", "int8", "int4", "raw"):
            c = codec.make_codec(name, dtype="float32", head_dim=4)
            assert codec.decode_payload(
                c, codec.encode_payload(c, body * 8), len(body) * 8)
        assert not any(blocked(m) for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


# ----------------------------------------------------------- kernel build

def test_kernel_library_name_covers_source_and_shared_header(tmp_path,
                                                             monkeypatch):
    """A library is named by a digest of its source and of the headers of
    csrc/ it may include, so editing either rebuilds it and an unchanged
    pair is reused (nothing is compiled here)."""
    from production_stack_tpu_torch import kernels
    src, header = tmp_path / "attn.cu", tmp_path / "tile.cuh"
    src.write_text('#include "tile.cuh"\n')
    header.write_text("// tile v1\n")
    monkeypatch.setattr(kernels, "SOURCES", {"attn": src})
    first = kernels.library_path("attn")
    assert first == kernels.library_path("attn")
    assert first.parent == kernels.BUILD_DIR
    header.write_text("// tile v2\n")
    after_header = kernels.library_path("attn")
    src.write_text('#include "tile.cuh"\n// edited\n')
    after_source = kernels.library_path("attn")
    assert len({first, after_header, after_source}) == 3
    # the port's own sources both include the shared tile
    monkeypatch.undo()
    for name in ("paged_attention", "flash_attention"):
        text = kernels.SOURCES[name].read_text()
        assert '#include "attention_tile.cuh"' in text


def test_kernel_resource_report_reads_ptxas_lines():
    """The build log's -Xptxas -v lines become per-kernel registers,
    static shared memory and spills (nothing is compiled here)."""
    from production_stack_tpu_torch import kernels
    assert kernels.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z4fooILi64EEvv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z4fooILi64EEvv",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, 1024 bytes smem, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3barv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]",
    ])
    report = kernels.resource_report(log)
    assert list(report.values()) == [
        {"spill_stores": 8, "spill_loads": 12, "registers": 168,
         "smem_bytes": 1024},
        {"spill_stores": 0, "spill_loads": 0, "registers": 40,
         "smem_bytes": 0}]
