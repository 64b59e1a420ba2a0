"""The MoE, q/k/v-bias and every-layer-window model families against
the JAX package on the CPU: mixture-of-experts (``debug-moe``, a tiny
Mixtral and a tiny Qwen2-MoE with its shared expert, made through
``from_hf_config`` as in tests/test_model_numerics.py), Qwen2's q/k/v
biases, a sliding window on every layer (``debug-sliding``) and its
rolling KV, int8 expert stacks, and the engine serving them.

Weights are drawn by the JAX package and carried across
(weights.params_from_jax); the JAX init zeroes the q/k/v biases, so the
Qwen2 cases draw biases of their own for both sides. Everything runs in
float32. Tolerances: logits 1e-4 (the same arithmetic summed in another
order by two libraries, through two or three layers); a token-by-token
decode against JAX's full-sequence forward_train 1e-3 (the JAX test's own
bound for that comparison); engine tokens exactly. Expert ids and drop
sets follow from the logits: a different expert or a dropped assignment
moves a token's MLP output by far more than 1e-4.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import lora as jlora
from production_stack_tpu.models import quant as jquant
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import parse_args
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import lora as tlora
from production_stack_tpu_torch.models import quant as tquant
from production_stack_tpu_torch.models.kv import make_slot_cache
from production_stack_tpu_torch.ops import moe as tmoe
from production_stack_tpu_torch.weights import (adapter_from_jax,
                                                cache_from_jax,
                                                params_from_jax)

from tests.torch_geometry import FIXED


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models run thousands of small ops one after another;
    with a thread pool per op they crawl when other test processes hold
    the cores. One intra-op thread keeps them fast either way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# HF config dicts of the tiny models of tests/test_model_numerics.py
HF_TINY = {
    "tiny-mixtral": {
        "model_type": "mixtral", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "num_local_experts": 4,
        "num_experts_per_tok": 2, "tie_word_embeddings": False},
    "tiny-qwen2-moe": {
        "model_type": "qwen2_moe", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "moe_intermediate_size": 48,
        "shared_expert_intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "num_experts": 4, "num_experts_per_tok": 2,
        "norm_topk_prob": False, "decoder_sparse_step": 1,
        "mlp_only_layers": [], "tie_word_embeddings": False},
    "tiny-qwen2": {
        "model_type": "qwen2", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "tie_word_embeddings": False},
}


def _cfgs(model, **replace):
    if model in HF_TINY:
        j = jconfig.ModelConfig.from_hf_config(HF_TINY[model], name=model,
                                               dtype=jnp.float32)
        t = tconfig.ModelConfig.from_hf_config(HF_TINY[model], name=model,
                                               dtype=torch.float32)
    else:
        j = dataclasses.replace(jconfig.get_config(model), dtype=jnp.float32)
        t = dataclasses.replace(tconfig.get_config(model),
                                dtype=torch.float32)
    return (dataclasses.replace(j, **replace),
            dataclasses.replace(t, **replace))


def _pair(model, seed, quantize=False, **replace):
    """(jcfg, tcfg, JAX params, the port's module of the same weights);
    biases drawn N(0, 0.1) on both sides where the model has them."""
    jcfg, tcfg = _cfgs(model, **replace)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    if jcfg.attention_bias:
        rng = np.random.default_rng(seed + 100)
        for name in ("q_bias", "k_bias", "v_bias"):
            shape = jparams["layers"][name].shape
            jparams["layers"][name] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
    if quantize:
        jparams = jquant.quantize_params(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _forward_check(jcfg, tcfg, jparams, tparams, chunks, decode_steps,
                   B=3, Bs=8, seed=4, lens=None):
    """Prefill `chunks` [(lo, hi)] (the first one ragged by `lens`, right
    padding masked by token_valid), then decode steps, through both
    forwards over the same paged pool and shuffled tables; logits of the
    real tokens to 1e-4."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    end = chunks[-1][1] + decode_steps
    MB = -(-end // Bs) + 1
    N = B * MB + 2
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.float32)
    tcache, ttables = cache_from_jax(np.asarray(jcache.k),
                                     np.asarray(jcache.v), tables,
                                     dtype=torch.float32, device="cpu")

    jforward = jax.jit(
        lambda p, t, pos, c, tab, v, kv_len: jllama.forward(
            p, jcfg, t, pos, c, block_tables=tab, kv_len=kv_len,
            token_valid=v), static_argnames="kv_len")

    def check(tokens, positions, valid, kv_len):
        nonlocal jcache
        jl, jcache = jforward(jparams, jnp.asarray(tokens),
                              jnp.asarray(positions), jcache,
                              jnp.asarray(tables), jnp.asarray(valid),
                              kv_len=kv_len)
        tl, _ = tllama.forward(
            tparams, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, block_tables=ttables,
            kv_len=kv_len, token_valid=torch.from_numpy(valid))
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   rtol=0, atol=1e-4)

    for lo, hi in chunks:
        T = hi - lo
        tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
        positions = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                    (B, T)).copy()
        valid = np.ones((B, T), bool)
        if lo == 0 and lens is not None:
            valid = np.arange(T)[None, :] < np.asarray(lens)[:, None]
        check(tokens, positions, valid, kv_len=hi)
    last = chunks[-1][1]
    for step in range(decode_steps):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        check(tok, np.full((B, 1), last + step, np.int32),
              np.ones((B, 1), bool), kv_len=end)


@contextlib.contextmanager
def _counting_drops():
    """A list that collects, per dispatch of the port's MoE, how many
    real tokens' assignments it dropped."""
    dropped = []
    plan = tmoe.dispatch_plan

    def counted(top_i, E, capacity, valid=None):
        dest = plan(top_i, E, capacity, valid)
        if valid is not None:
            dropped.append(int(((dest == E * capacity) & valid
                                .repeat_interleave(top_i.shape[1])).sum()))
        return dest
    tmoe.dispatch_plan = counted
    try:
        yield dropped
    finally:
        tmoe.dispatch_plan = plan


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("model,replace,chunk", [
    # N = 3 x 12 tokens: the exact path in prefill and decode
    ("debug-moe", {}, 12),
    # N = 3 x 32 > 64 at factor 0.8: capacity 40 < N, the dispatch path
    # drops assignments (the real tokens of the first, ragged chunk)
    ("debug-moe", {"moe_capacity_factor": 0.8}, 32),
    ("tiny-mixtral", {}, 20),
    ("tiny-qwen2-moe", {"moe_capacity_factor": 0.8}, 32),
    ("tiny-qwen2", {}, 20),
])
def test_forward_prefill_then_decode_matches_jax(model, replace, chunk):
    jcfg, tcfg, jparams, tparams = _pair(model, 2, **replace)
    if model == "tiny-qwen2":
        assert tcfg.attention_bias and not tcfg.num_experts
    if model == "tiny-qwen2-moe":
        assert tcfg.shared_expert_size == 96 and not tcfg.norm_topk_prob
    lens = [chunk, chunk - 5, chunk - 2]
    with _counting_drops() as dropped:
        _forward_check(jcfg, tcfg, jparams, tparams,
                       [(0, chunk), (chunk, chunk + 8)], 3, lens=lens)
    if replace:
        assert sum(dropped) > 0, "the dispatch path dropped nothing"


@pytest.mark.parametrize("model", ["debug-moe", "tiny-qwen2-moe"])
def test_incremental_decode_matches_jax_forward_train(model):
    """Token-by-token decode through the port's paged forward (T = 1:
    the exact path) against JAX's full-sequence forward_train."""
    jcfg, tcfg, jparams, tparams = _pair(model, 3)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (1, 12))
    full = np.asarray(jllama.forward_train(jparams, jcfg,
                                           jnp.asarray(toks)))
    cache, tables = make_slot_cache(
        tcfg.num_layers, 1, 16, tcfg.num_kv_heads, tcfg.head_dim_,
        dtype=torch.float32, block_size=8, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, _ = tllama.forward(
            tparams, tcfg, torch.tensor(toks[:, t:t + 1], dtype=torch.int32),
            torch.tensor([[t]], dtype=torch.int32), cache,
            block_tables=tables, kv_len=16)
        outs.append(logits.numpy()[:, 0])
    np.testing.assert_allclose(np.stack(outs, axis=1), full, rtol=0,
                               atol=1e-3)


def test_sliding_every_layer_forward_past_the_window_matches_jax():
    """debug-sliding (window 64 on both layers): prefill to position 96
    in two chunks, then decode steps, so every layer drops the keys
    behind its window."""
    jcfg, tcfg, jparams, tparams = _pair("debug-sliding", 5)
    assert [tllama.layer_window(tcfg, l) for l in range(2)] == [64, 64]
    _forward_check(jcfg, tcfg, jparams, tparams, [(0, 48), (48, 96)], 6,
                   B=2, Bs=16)


def test_int8_moe_forward_matches_jax():
    """debug-moe with JAX-quantized weights carried across (the expert
    stacks int8 per expert and output channel, scale [L, E, out]; the
    router unquantized): equal int8 leaves to the port's own
    quantize_params of the same f32 weights, and logits to 1e-4."""
    jcfg, tcfg, jparams, tparams = _pair("debug-moe", 6, quantize=True)
    assert tquant.is_quantized(tparams.gate)
    assert tuple(tparams.gate.scale.shape) == (2, 4, 256)
    assert not tquant.is_quantized(tparams.router)
    _, _, _, f32 = _pair("debug-moe", 6)
    mine = tquant.quantize_params(f32)
    for name in ("gate", "up", "down", "q"):
        np.testing.assert_array_equal(getattr(mine, name).w8.numpy(),
                                      getattr(tparams, name).w8.numpy())
        np.testing.assert_array_equal(getattr(mine, name).scale.numpy(),
                                      getattr(tparams, name).scale.numpy())
    _forward_check(jcfg, tcfg, jparams, tparams, [(0, 32), (32, 40)], 3,
                   lens=[32, 20, 9])


def test_encode_moe_ignores_padding_content():
    """encode (the pooling routes) masks padding: changing the pads'
    content changes no real position's hidden state, at a capacity
    factor low enough for the dispatch to drop; equal to JAX's encode."""
    jcfg, tcfg, jparams, tparams = _pair(
        "debug-moe", 0, num_experts=8, moe_capacity_factor=0.8)
    rng = np.random.default_rng(0)
    T = 120
    lengths = np.array([T, 40])
    toks = rng.integers(0, jcfg.vocab_size, (2, T))
    mask = np.arange(T)[None, :] < lengths[:, None]
    other = toks.copy()
    other[~mask] = 7
    outs = []
    for t in (toks, other):
        got = tllama.encode(tparams, tcfg, torch.from_numpy(t),
                            token_valid=torch.from_numpy(mask)).numpy()
        want = np.asarray(jllama.encode(jparams, jcfg, jnp.asarray(t),
                                        token_valid=jnp.asarray(mask)))
        np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-4)
        outs.append(got)
    np.testing.assert_allclose(outs[0][mask], outs[1][mask], rtol=0,
                               atol=1e-6)


def test_qwen2_bias_comes_before_the_adapter_delta():
    """tiny Qwen2 (biases on q/k/v) with an adapter on q, k and v, rows
    [0, 1]: a prefill chunk, then decode steps; logits to 1e-4 of JAX's,
    whose proj adds the bias before the LoRA delta."""
    jcfg, tcfg, jparams, tparams = _pair("tiny-qwen2", 8)
    targets = ("q", "k", "v")
    jl = jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    jad = jlora.random_adapter(jcfg, jl, jax.random.PRNGKey(11))
    jstack = jlora.stack_adapters(jcfg, jl, [jad])
    tstack = tlora.stack_adapters(
        tcfg, tl, [adapter_from_jax(jax.tree_util.tree_map(np.asarray, jad),
                                    tcfg, device="cpu")], device="cpu")
    ids = np.array([0, 1], np.int32)
    rows = tlora.gather_rows(tlora.layer_slice(tstack),
                             torch.from_numpy(ids))
    jlayers = jlora.layer_slice(jstack)
    cache = jkv.make_cache(jcfg.num_layers, 12, 8, jcfg.num_kv_heads,
                           jcfg.head_dim_, dtype=jnp.float32)
    tcache, tables = cache_from_jax(np.asarray(cache.k), np.asarray(cache.v),
                                    np.arange(1, 11, dtype=np.int32)
                                    .reshape(2, 5), dtype=torch.float32,
                                    device="cpu")
    rng = np.random.default_rng(9)
    for lo, hi in ((0, 16), (16, 17), (17, 18)):
        toks = rng.integers(0, 256, (2, hi - lo)).astype(np.int32)
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (2, hi - lo)).copy()
        want, cache = jllama.forward(
            jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), cache,
            block_tables=jnp.asarray(tables.numpy()), kv_len=40,
            lora_params=jlayers, adapter_ids=jnp.asarray(ids),
            lora_scaling=jl.scaling)
        got, _ = tllama.forward(
            tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(pos),
            tcache, block_tables=tables, kv_len=40, lora_rows=rows,
            lora_scaling=tl.scaling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_lora_mlp_targets_refused_on_moe():
    """The experts bypass the LoRA hook: gate/up/down targets on a MoE
    model raise in both packages (and in the port's engine), attention
    targets stay fine."""
    jcfg, tcfg = _cfgs("debug-moe")
    with pytest.raises(ValueError, match="MoE"):
        jlora.init_adapter(jcfg, jlora.LoRAConfig(targets=("q", "gate")),
                           jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="MoE"):
        tlora.init_adapter(tcfg, tlora.LoRAConfig(targets=("q", "gate")),
                           device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tengine.LLMEngine(tec.EngineConfig(
            model="debug-moe", device="cpu", max_model_len=64,
            max_num_seqs=2, lora_adapters={"ad": "random:1"},
            lora_targets=("q", "down")))
    ad = tlora.init_adapter(tcfg, tlora.LoRAConfig(targets=("q", "v")),
                            device="cpu")
    assert set(ad) == {"q", "v"}


def test_moe_capacity_factor_reaches_the_model():
    eng = tengine.LLMEngine(tec.EngineConfig(
        model="debug-moe", device="cpu", max_model_len=64, max_num_seqs=2,
        moe_capacity_factor=3.5))
    assert eng.model_cfg.moe_capacity_factor == 3.5
    assert tengine.LLMEngine(tec.EngineConfig(
        model="debug-moe", device="cpu", max_model_len=64,
        max_num_seqs=2)).model_cfg.moe_capacity_factor == 2.0
    assert parse_args(["--moe-capacity-factor", "0.5"]) \
        .moe_capacity_factor == 0.5


# ------------------------------------------------------------------ engine

def _run(engine, opts_cls, prompts, budgets):
    ids = [engine.add_request(p, opts_cls(temperature=0.0, max_tokens=m,
                                          ignore_eos=True))
           for p, m in zip(prompts, budgets)]
    while engine.has_work:
        engine.step()
    return [engine.seqs[i].output_tokens for i in ids]


@pytest.mark.parametrize("kw", [
    {},
    {"speculative_ngram_tokens": 3},
    {"quantization": "int8"},
])
def test_engine_moe_tokens_equal_jax_engine(kw):
    """debug-moe at capacity factor 0.5 through both engines: five
    prompts of mixed lengths through three slots, chunked prefill (full
    batch of 3 x 32 tokens: the dispatch path, dropping) interleaved
    with decode windows (the exact path), and with speculation the
    verify windows (N = 3 x 4: exact), or int8 weights. Greedy tokens
    equal the JAX engine's, and the port's prefill dropped
    assignments."""
    jcfg, _, jparams, tparams = _pair("debug-moe", 2)
    common = dict(model="debug-moe", dtype="float32", kv_dtype="float32",
                  max_model_len=128, max_num_seqs=3, prefill_chunk=32,
                  prefill_buckets=(16, 32), decode_window=4,
                  kv_block_size=8, moe_capacity_factor=0.5, **kw)
    je = jengine.LLMEngine(jec.EngineConfig(**common, window_adapt=False,
                                            pipeline_depth=1),
                           params=jparams)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED),
                           params=tparams)
    rng = np.random.default_rng(6)
    # a repetitive prompt gives the n-gram drafts something to match
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 70, 12)]
    prompts.append([5, 6, 7, 8] * 6)
    budgets = (10, 6, 12, 20, 16)
    with _counting_drops() as dropped:
        got = _run(te, SamplingOptions, prompts, budgets)
    assert [len(t) for t in got] == list(budgets)
    assert got == _run(je, JSamplingOptions, prompts, budgets)
    assert sum(dropped) > 0


def _rolling_engine(pool_tokens, prefix_caching=False, jax_engine=False):
    common = dict(model="debug-sliding", dtype="float32",
                  kv_dtype="float32", max_model_len=512, max_num_seqs=2,
                  prefill_chunk=32, prefill_buckets=(32,), decode_window=4,
                  kv_block_size=16, kv_pool_tokens=pool_tokens,
                  enable_prefix_caching=prefix_caching)
    _, _, jparams, tparams = _pair("debug-sliding", 0)
    if jax_engine:
        # pipeline_depth 1, the port's: at its default of 2 the JAX
        # engine's tokens on this rolling setup vary from run to run on
        # a loaded CPU (ROADMAP Queue C)
        return jengine.LLMEngine(jec.EngineConfig(**common,
                                                  window_adapt=False,
                                                  pipeline_depth=1),
                                 params=jparams)
    return tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                              **FIXED),
                             params=tparams)


def test_rolling_kv_frees_behind_window_and_tokens_equal_jax():
    """tests/test_sliding_window.py's setup: two concurrent 300-token
    generations (worst case 2 x 332 tokens of KV) on a pool of 512
    tokens finish without a preemption because blocks behind the 64-token
    window roll; their tokens equal a big-pool run's and the JAX
    engine's on the same small pool."""
    prompts = [list(range(3 + j, 35 + j)) for j in range(2)]

    def run(engine, opts_cls):
        toks = _run(engine, opts_cls, prompts, (300, 300))
        return toks, engine

    small, te = run(_rolling_engine(512), SamplingOptions)
    assert max(te.seqs[s].rolled_blocks for s in te.seqs) > 0
    preempted = [float(line.rsplit(" ", 1)[1]) for line in
                 te.render_metrics().decode().splitlines()
                 if line.startswith("vllm:num_preemptions_total")]
    assert preempted == [0.0]
    assert all(len(t) == 300 for t in small)
    big, _ = run(_rolling_engine(None), SamplingOptions)
    assert small == big
    want, _ = run(_rolling_engine(512, jax_engine=True), JSamplingOptions)
    assert small == want


def test_rolling_kv_skips_finish_registration():
    """A rolled sequence registers its prompt's blocks at prefill (live
    sharing) but no output chain at finish: its early blocks are gone."""
    eng = _rolling_engine(None, prefix_caching=True)
    sid = eng.add_request(list(range(3, 35)), SamplingOptions(
        temperature=0.0, max_tokens=200, ignore_eos=True))
    keys_after_prefill = None
    while eng.has_work:
        eng.step()
        if keys_after_prefill is None and eng.seqs[sid].output_tokens:
            keys_after_prefill = set(eng.block_mgr._by_key)
    assert eng.seqs[sid].rolled_blocks > 0
    assert len(keys_after_prefill) == 2    # the prompt's full blocks
    assert set(eng.block_mgr._by_key) == keys_after_prefill
