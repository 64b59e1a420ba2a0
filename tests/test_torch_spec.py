"""The PyTorch port's n-gram (prompt-lookup) speculation against the JAX
package's on the CPU: the setups of tests/test_engine.py
(test_speculative_ngram_exact_greedy_parity and
test_speculative_per_row_gating_mixed_batch) run through both engines,
a batch mixing speculating rows with guided, shaped and top-K rows, a
row that reaches max_model_len inside a macro-step (where the JAX
engine's clamped slices shift the draft and the history write), and a
bounded pool that preempts under speculation.

Weights are drawn once by the JAX package and carried across
(weights.params_from_jax) in float32, where greedy tokens are exact:
they must equal the JAX engine's and the port's own speculation-free
tokens, and the speculation counters
(tpu:spec_accepted_draft_tokens_total, tpu:spec_macro_steps_total)
must equal the JAX engine's exactly. The JAX engine runs one window in
flight (pipeline_depth 1), as the port does.
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
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import params_from_jax

from tests.torch_geometry import FIXED

# the engine geometry of the JAX package's speculation tests
_SPEC = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
             max_model_len=512, max_num_seqs=2, prefill_chunk=64,
             prefill_buckets=(64,), decode_window=4)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(np_params, tcfg, device="cpu")


def _engines(weights, spec, **kw):
    """(JAX engine, port engine) over the same weights."""
    jparams, tparams = weights
    cfg = dict(_SPEC, speculative_ngram_tokens=spec, **kw)
    return (jengine.LLMEngine(jec.EngineConfig(**cfg, pipeline_depth=1,
                                               window_adapt=False),
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


def _spec_counters(engine):
    """(accepted draft tokens, macro-steps) of an engine's /metrics."""
    got = {s.name: s.value for f in text_string_to_metric_families(
        engine.render_metrics().decode()) for s in f.samples}
    return (got["tpu:spec_accepted_draft_tokens_total"],
            got["tpu:spec_macro_steps_total"])


class _TCount:
    """Counts the attention calls of the port's forward by (kernel, T)."""

    def __init__(self, monkeypatch):
        from production_stack_tpu_torch.ops import paged_attention as pa
        self.calls = {}
        for name in ("paged_attention", "paged_decode_attention"):
            fn = getattr(pa, name)

            def wrapped(q, *a, _fn=fn, _name=name, **k):
                key = (_name, q.shape[1])
                self.calls[key] = self.calls.get(key, 0) + 1
                return _fn(q, *a, **k)
            monkeypatch.setattr(pa, name, wrapped)


def _greedy(n, **kw):
    return dict(temperature=0.0, max_tokens=n, ignore_eos=True, **kw)


@pytest.mark.parametrize("spec", [3, 8])
def test_speculative_exact_greedy_parity_equals_jax(weights, spec,
                                                    monkeypatch):
    """JAX's exact-greedy setup: a repetitive prompt (a 12-token base x
    6, 24 tokens) and a non-repetitive one (80 tokens, 16). The port's
    tokens with speculation equal its tokens without and the JAX
    engine's with it; the counters equal JAX's and show accepted
    drafts on the repetitive prompt. The verify forward takes the
    decode kernel's path at spec + 1 = 4 and the prefill kernel's at
    spec + 1 = 9."""
    rng = np.random.default_rng(0)
    rep = rng.integers(1, 40, size=(12,)).tolist() * 6
    other = rng.integers(1, 250, size=(80,)).tolist()
    counted = _TCount(monkeypatch)
    for prompt, n in ((rep, 24), (other, 16)):
        je, te = _engines(weights, spec)
        _, t0 = _engines(weights, 0)
        want = _run(je, JSamplingOptions, [prompt], [_greedy(n)])[0]
        got = _run(te, SamplingOptions, [prompt], [_greedy(n)])[0]
        plain = _run(t0, SamplingOptions, [prompt], [_greedy(n)])[0]
        assert got.output_tokens == plain.output_tokens == \
            want.output_tokens
        np.testing.assert_allclose(got.output_logprobs,
                                   want.output_logprobs, rtol=0, atol=1e-4)
        counters = _spec_counters(te)
        assert counters == _spec_counters(je)
        if prompt is rep:
            assert counters[0] > 0 and counters[1] < n, counters
    kernel = ("paged_decode_attention" if spec + 1 <= 8
              else "paged_attention")
    assert counted.calls.get((kernel, spec + 1), 0) > 0, counted.calls


def test_speculative_per_row_gating_mixed_batch_equals_jax(weights):
    """JAX's per-row gating setup: a plain greedy row and a shaped
    (presence_penalty) row share the windows of a speculating engine.
    Both emit what they emit alone without speculation, the tokens
    equal the JAX engine's, the plain row speculated (accepted drafts,
    fewer macro-steps than tokens) and the counters equal JAX's."""
    rng = np.random.default_rng(3)
    rep = rng.integers(1, 40, size=(12,)).tolist() * 6
    rows = [_greedy(24), _greedy(24, presence_penalty=0.7)]
    alone = []
    for row in rows:
        _, t0 = _engines(weights, 0)
        alone.append(_run(t0, SamplingOptions, [rep], [row])[0]
                     .output_tokens)
    je, te = _engines(weights, 3)
    want = _run(je, JSamplingOptions, [rep, rep], rows)
    got = _run(te, SamplingOptions, [rep, rep], rows)
    assert [s.output_tokens for s in got] == alone == \
        [s.output_tokens for s in want]
    accepted, steps = _spec_counters(te)
    assert (accepted, steps) == _spec_counters(je)
    assert accepted > 0 and steps < 24


def test_speculative_mixed_rows_equal_jax(weights):
    """Four rows in the windows of a spec-3 engine: a speculating
    greedy row, a guided greedy row, a shaped row and a top_logprobs
    row (the three decline speculation for themselves). Tokens, finish
    reasons, logprobs (1e-5) and the alternatives (1e-5) equal the JAX
    engine's, and so do the counters."""
    rng = np.random.default_rng(5)
    rep = rng.integers(1, 40, size=(12,)).tolist() * 5
    prompts = [rep, [256] + list(b"colour?"), rep[:30], rep[10:50]]
    rows = [_greedy(20),
            dict(temperature=0.0, max_tokens=16,
                 guided_regex=r"(red|green|blue)!"),
            _greedy(20, frequency_penalty=0.8, logit_bias={9: 3.0}),
            _greedy(20, top_logprobs=3)]
    je, te = _engines(weights, 3, max_num_seqs=4)
    want = _run(je, JSamplingOptions, prompts, rows)
    got = _run(te, SamplingOptions, prompts, rows)
    for g, w in zip(got, want):
        assert (g.output_tokens, g.finish_reason) == \
            (w.output_tokens, w.finish_reason)
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   rtol=0, atol=1e-5)
    for (gi, gl), (wi, wl) in zip(
            [a for t in got[3].output_top for a in t],
            [a for t in want[3].output_top for a in t]):
        assert abs(gl - wl) <= 1e-5
    assert got[1].output_text in ("red!", "green!", "blue!")
    assert _spec_counters(te) == _spec_counters(je)
    assert _spec_counters(te)[0] > 0


@pytest.mark.parametrize("spec", [3, 8])
def test_speculation_into_max_model_len_equals_jax(weights, spec):
    """Rows that run into max_model_len (96) inside a macro-step: near
    the end the JAX engine's clamped slices read the draft from, and
    write the history to, shifted places, and the port clamps as they
    do. Tokens, finish reasons and the counters equal the JAX
    engine's."""
    rng = np.random.default_rng(7)
    base = rng.integers(1, 40, size=(8,)).tolist()
    prompts = [base * 9, base * 7 + base[:5]]
    rows = [_greedy(100), _greedy(100)]
    je, te = _engines(weights, spec, max_model_len=96, prefill_chunk=32,
                      prefill_buckets=(32,))
    want = _run(je, JSamplingOptions, prompts, rows)
    got = _run(te, SamplingOptions, prompts, rows)
    for g, w in zip(got, want):
        assert (g.output_tokens, g.finish_reason) == \
            (w.output_tokens, w.finish_reason)
        assert g.finish_reason == "length"
        assert len(g.prompt_tokens) + len(g.output_tokens) == 96
    assert _spec_counters(te) == _spec_counters(je)


def test_speculation_on_a_bounded_pool_preempts_as_jax(weights):
    """Four sequences in three slots over a pool of 160 tokens: a
    spec-3 window needs W * 4 + 1 positions of blocks past each row,
    so the youngest sequences are preempted and recomputed. The
    preemptions, tokens, finish reasons and counters equal the JAX
    engine's."""
    rng = np.random.default_rng(9)
    base = rng.integers(1, 40, size=(10,)).tolist()
    prompts = [base * 4, base * 3 + [7], rng.integers(1, 250, 30).tolist(),
               base * 2]
    rows = [_greedy(30), _greedy(24), _greedy(20), _greedy(28)]
    je, te = _engines(weights, 3, max_model_len=128, max_num_seqs=3,
                      prefill_chunk=32, prefill_buckets=(16, 32),
                      kv_block_size=8, kv_pool_tokens=160)
    want = _run(je, JSamplingOptions, prompts, rows)
    got = _run(te, SamplingOptions, prompts, rows)
    for g, w in zip(got, want):
        assert (g.output_tokens, g.finish_reason) == \
            (w.output_tokens, w.finish_reason)

    def preemptions(engine):
        return next(s.value for f in text_string_to_metric_families(
            engine.render_metrics().decode()) for s in f.samples
            if s.name == "vllm:num_preemptions_total")
    assert preemptions(te) == preemptions(je) > 0
    assert _spec_counters(te) == _spec_counters(je)


def test_runner_draft_matches_the_jax_rule():
    """The draft of a row is what follows the latest prior occurrence
    of its bigram, after position 0 when there is none, and reads from
    a start clamped to S - K near the end of the history."""
    from production_stack_tpu_torch.engine.runner import _draft
    S, K = 16, 3
    hist = torch.tensor([[5, 1, 2, 9, 8, 1, 2, 7, 6, 1, 2, 0, 0, 0, 0, 0],
                         [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                          7, 7, 7],
                         [4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          0]], dtype=torch.int32)
    pos = torch.tensor([10, 15, 3], dtype=torch.int32)
    draft = _draft(hist, pos, K)
    # row 0: bigram (1, 2) last seen ending at 6 -> tokens 7..9
    # row 1: bigram (7, 7) ends at 14 -> start 15, clamped to 13
    # row 2: (4, 4) ends at 2 -> tokens 3..5
    assert draft.tolist() == [[7, 6, 1], [7, 7, 7], [4, 0, 0]]


def test_speculative_config_range_matches_jax():
    """speculative_ngram_tokens takes 0..16, as the JAX config does."""
    for bad in (-1, 17):
        with pytest.raises(ValueError, match="0..16"):
            tec.EngineConfig(model="debug-tiny", device="cpu",
                             speculative_ngram_tokens=bad)
    cfg = tec.EngineConfig(model="debug-tiny", device="cpu",
                           speculative_ngram_tokens=16)
    assert cfg.speculative_ngram_tokens == 16 and not cfg.window_adapt
