"""The PyTorch port's logit shaping and logprobs against the JAX
package's on the CPU: ``sampler.adjust_logits`` on random inputs, the
engine's greedy tokens with shaped and plain rows sharing a decode
window (with and without preemption), ``min_tokens`` against stop ids,
top-K alternatives, and teacher-forced prompt logprobs (Gemma-2's final
softcap and an int8 LM head included).

Engines and runners compare in float32 on weights drawn once by the JAX
package and carried across (weights.params_from_jax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

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
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

from tests.torch_geometry import FIXED


def _weights(seed=0, model="debug-tiny"):
    jcfg = dataclasses.replace(jconfig.get_config(model),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config(model),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, tcfg,
                                                   device="cpu")


# ----------------------------------------------------------- adjust_logits

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjust_logits_equals_jax(seed):
    """Seeded [B, V] logits, generated-token counts, prompt membership,
    logit bias (unused slots too), stop ids (a repeat, the EOS id, an
    unused slot) and rows below and at their min_tokens floor: the port
    equals JAX to 1e-6."""
    rng = np.random.default_rng(seed)
    B, V, eos = 4, 64, 9
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) * (
        rng.random((B, V)) < 0.2)
    seen = rng.random((B, V)) < 0.15
    out_len = np.array([0, 3, 7, 2], np.int32)
    fields = dict(
        presence=rng.uniform(-2, 2, B).astype(np.float32),
        frequency=rng.uniform(-2, 2, B).astype(np.float32),
        repetition=rng.uniform(0.5, 2, B).astype(np.float32),
        min_tokens=np.array([1, 3, 5, 0], np.int32),
        prompt_len=np.zeros(B, np.int32))
    bias_ids = np.full((B, tsampler.LOGIT_BIAS_K), -1, np.int32)
    bias_vals = np.zeros((B, tsampler.LOGIT_BIAS_K), np.float32)
    for b in range(B):
        ids = rng.choice(V, size=5, replace=False)
        bias_ids[b, :5] = np.sort(ids)
        bias_vals[b, :5] = rng.uniform(-100, 100, 5)
    stop_ids = np.full((B, tsampler.MIN_TOKENS_STOP_K), -1, np.int32)
    stop_ids[0, :3] = [4, 4, 0]
    stop_ids[2, :2] = [eos, 17]
    jp = jsampler.SamplingParams.filled(B)._replace(
        bias_ids=jnp.asarray(bias_ids), bias_vals=jnp.asarray(bias_vals),
        stop_ids=jnp.asarray(stop_ids),
        **{k: jnp.asarray(v) for k, v in fields.items()})
    tp = dataclasses.replace(
        tsampler.SamplingParams.filled(B, device="cpu"),
        bias_ids=torch.from_numpy(bias_ids),
        bias_vals=torch.from_numpy(bias_vals),
        stop_ids=torch.from_numpy(stop_ids),
        **{k: torch.from_numpy(v) for k, v in fields.items()})
    want = np.asarray(jsampler.adjust_logits(
        jnp.asarray(logits), jp, jnp.asarray(counts), jnp.asarray(seen),
        jnp.asarray(out_len), eos))
    got = tsampler.adjust_logits(
        torch.from_numpy(logits), tp, torch.from_numpy(counts),
        torch.from_numpy(seen), torch.from_numpy(out_len), eos).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # row 0 (out_len 0 < 1) bans EOS, 4 and 0; row 3 (floor 0) bans none
    assert (got[0, [eos, 4, 0]] == -1e30).all()
    assert (got[3] > -1e29).all()


# ------------------------------------------------------------------ engine

_F32 = dict(model="debug-tiny", dtype="float32", kv_dtype="float32")

# shaped and plain rows: penalties, logit bias, min_tokens with stop ids,
# top-K, and untouched rows, all greedy
_ROWS = [
    dict(presence_penalty=1.5, frequency_penalty=1.0,
         repetition_penalty=1.3, top_logprobs=3),
    dict(),
    dict(logit_bias={7: 4.0, 9: 2.5}, top_logprobs=5),
    dict(repetition_penalty=0.7, frequency_penalty=-0.5),
    dict(top_logprobs=2),
]


def _run(engine, opts_cls, prompts, rows, max_tokens):
    ids = [engine.add_request(p, opts_cls(temperature=0.0,
                                          max_tokens=max_tokens,
                                          ignore_eos=True, **kw))
           for p, kw in zip(prompts, rows)]
    while engine.has_work:
        engine.step()
    return [engine.seqs[i] for i in ids]


def _assert_tops_close(got, want):
    """Top-K values to 1e-5; ids equal wherever values are not tied."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert len(g) == len(w)
        np.testing.assert_allclose([l for _, l in g], [l for _, l in w],
                                   rtol=0, atol=1e-5)
        lw = [l for _, l in w]
        for i, ((gi, _), (wi, _)) in enumerate(zip(g, w)):
            tied = any(abs(lw[i] - lw[j]) < 1e-5
                       for j in range(len(lw)) if j != i)
            if not tied:
                assert gi == wi


@pytest.mark.parametrize("pool", [None, 1], ids=["pool", "preempting"])
def test_engine_shaped_and_plain_rows_equal_jax(pool):
    """Five prompts, three slots, W = 8: shaped rows beside plain ones in
    the same windows, and with the smallest pool (one full-length
    sequence, 128 tokens) the youngest sequences are preempted and
    recomputed (their counts rebuilt from their own
    output). Greedy tokens equal the JAX engine's, logprobs to 1e-5,
    top-K alternatives to 1e-5 with ids equal where not tied."""
    _, _, jparams, tparams = _weights(3)
    common = dict(_F32, max_model_len=128, max_num_seqs=3,
                  prefill_chunk=32, prefill_buckets=(16, 32),
                  decode_window=8, kv_block_size=8, kv_pool_tokens=pool)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).tolist()
               for n in (30, 50, 40, 20, 35)]
    want = _run(je, JSamplingOptions, prompts, _ROWS, 24)
    got = _run(te, SamplingOptions, prompts, _ROWS, 24)
    if pool is not None:
        preempted = [
            s.value for f in text_string_to_metric_families(
                te.render_metrics().decode())
            for s in f.samples if s.name == "vllm:num_preemptions_total"]
        assert preempted[0] > 0, "nothing was preempted"
    for g, w in zip(got, want):
        assert g.output_tokens == w.output_tokens
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   rtol=0, atol=1e-5)
        _assert_tops_close(g.output_top, w.output_top)


def test_min_tokens_with_stop_ids_equals_jax():
    """min_tokens bans EOS and the request's stop ids below the floor:
    with both biased +100 the sequence stops at exactly min_tokens, on
    the stop id, in both engines; without the floor it stops at once."""
    _, _, jparams, tparams = _weights(4)
    common = dict(_F32, max_model_len=64, max_num_seqs=2, prefill_chunk=16,
                  prefill_buckets=(16,), decode_window=8, kv_block_size=8)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    prompts = [[256, 5, 6, 7], [256, 9, 9]]
    rows = [dict(min_tokens=11, stop_token_ids=[42],
                 logit_bias={42: 100.0}),
            dict(stop_token_ids=[42], logit_bias={42: 100.0})]
    def run(engine, opts_cls):
        return [(s.output_tokens, s.finish_reason)
                for s in _run(engine, opts_cls, prompts, rows, 30)]

    want, got = run(je, JSamplingOptions), run(te, SamplingOptions)
    assert got == want
    assert len(got[0][0]) == 12 and got[0][0][-1] == 42
    assert got[0][1] == "stop" and 42 not in got[0][0][:-1]
    assert got[1][0] == [42]


def test_min_tokens_out_of_vocab_stop_ids_equal_jax_and_serve_on():
    """min_tokens with stop ids outside the vocabulary (V + 5, -3) beside
    one inside it: the outside ids ban nothing, as the JAX sampler's
    scatter drops them, so the tokens equal the JAX engine's. A stop id
    past int32 (which the JAX engine cannot hold in its int32 slots)
    bans nothing either, and the engine serves the next request."""
    _, tcfg, jparams, tparams = _weights(4)
    V = tcfg.vocab_size
    common = dict(_F32, max_model_len=64, max_num_seqs=2, prefill_chunk=16,
                  prefill_buckets=(16,), decode_window=8, kv_block_size=8)
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    row = dict(min_tokens=6, stop_token_ids=[V + 5, 42, -3],
               logit_bias={42: 100.0})
    want = _run(je, JSamplingOptions, [[256, 5, 6, 7]], [row], 12)[0]
    got = _run(te, SamplingOptions, [[256, 5, 6, 7]], [row], 12)[0]
    assert got.output_tokens == want.output_tokens
    assert len(got.output_tokens) == 7 and got.output_tokens[-1] == 42
    huge = dict(min_tokens=4, stop_token_ids=[2 ** 40, V + 5])
    after = _run(te, SamplingOptions, [[256, 1, 2], [256, 3, 4]],
                 [huge, {}], 5)
    assert [len(s.output_tokens) for s in after] == [5, 5]


# --------------------------------------------------------- prompt logprobs

@pytest.mark.parametrize("model,quantization", [
    ("debug-tiny", None), ("debug-gemma2", None), ("debug-tiny", "int8")])
def test_prompt_logprobs_equal_jax(model, quantization):
    """Teacher-forced logprobs of two ragged prompts (50 and 23 tokens,
    through 16-token prefill chunks) against the JAX runner's, to 1e-4;
    Gemma-2 with its final softcap, and an int8 LM head with its
    per-vocab scale."""
    _, tcfg, jparams, tparams = _weights(5, model)
    common = dict(model=model, dtype="float32", kv_dtype="float32",
                  max_model_len=128, max_num_seqs=2, prefill_chunk=16,
                  prefill_buckets=(16,), kv_block_size=8,
                  quantization=quantization)
    jr = jrunner.ModelRunner(
        dataclasses.replace(jconfig.get_config(model), dtype=jnp.float32),
        jec.EngineConfig(**common, window_adapt=False), params=jparams)
    tr = trunner.ModelRunner(tcfg, tec.EngineConfig(**common, device="cpu"),
                             params=tparams)
    rng = np.random.default_rng(6)
    T = 50
    tokens = np.zeros((2, T), np.int32)
    tokens[0] = rng.integers(0, 256, T)
    tokens[1, :23] = rng.integers(0, 256, 23)
    want = np.asarray(jr.prompt_logprobs(tokens))
    got = tr.prompt_logprobs(tokens).numpy()
    assert got.shape == (2, T - 1)
    np.testing.assert_allclose(got[0], want[0, :T - 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1, :22], want[1, :22], rtol=0,
                               atol=1e-4)
    assert (got <= 0).all()


def test_prompt_logprobs_of_out_of_vocab_ids_equal_jax():
    """Prompt ids outside the vocabulary as logprob targets read as the
    JAX runner's jnp.take_along_axis reads them: ids in [-V, 0) wrap,
    the others are NaN, and every other entry is the JAX runner's to
    1e-4 (the embedding takes the index rule of _embed)."""
    _, tcfg, jparams, tparams = _weights(5)
    V = tcfg.vocab_size
    common = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
                  max_model_len=64, max_num_seqs=2, prefill_chunk=16,
                  prefill_buckets=(16,), kv_block_size=8)
    jr = jrunner.ModelRunner(
        dataclasses.replace(jconfig.get_config("debug-tiny"),
                            dtype=jnp.float32),
        jec.EngineConfig(**common, window_adapt=False), params=jparams)
    tr = trunner.ModelRunner(tcfg, tec.EngineConfig(**common, device="cpu"),
                             params=tparams)
    row = [1, V + 100, -5, -(V + 100), V - 1, -V, 2 ** 30, 3]
    tokens = np.array([row, [256, 7, 8, 9, 10, 11, 12, 13]], np.int32)
    want = np.asarray(jr.prompt_logprobs(tokens))[:, :len(row) - 1]
    got = tr.prompt_logprobs(tokens).numpy()
    nan = [i - 1 for i, t in enumerate(row)
           if i and not -V <= t < V]
    assert nan == [0, 2, 5]
    assert np.isnan(want[0, nan]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
