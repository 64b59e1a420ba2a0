"""Parity of the PyTorch port's model with the JAX package's on the CPU:
the configuration table, carrying weights across, and the forward
through the paged pool (a prefill chunk, then decode steps) of the Llama
baseline and of Gemma-2 past its sliding window.

Weights are drawn once by the JAX package and carried across
(weights.params_from_jax), never re-drawn. Tolerances:
- float32 logits: 1e-4 — the same arithmetic, summed in another order
  by two libraries' matmuls and softmax over two layers;
- bfloat16 logits: 5e-2 of the largest logit — both sides round
  activations to bf16 after every matmul and norm, but not always at
  the same points (XLA fuses casts that eager PyTorch performs), and a
  bf16 rounding is 2^-8 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.weights import cache_from_jax, params_from_jax

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def test_presets_match_jax_field_by_field():
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    assert tconfig.HF_ALIASES == jconfig.HF_ALIASES
    for name, jc in jconfig.PRESETS.items():
        tc = tconfig.PRESETS[name]
        for f in dataclasses.fields(jc):
            jv, tv = getattr(jc, f.name), getattr(tc, f.name)
            if f.name == "dtype":
                assert (jv, tv) == (jnp.bfloat16, torch.bfloat16)
            else:
                assert tv == jv, (name, f.name)
        assert tc.head_dim_ == jc.head_dim_
        assert tc.num_params == jc.num_params


def _jax_model(dtype: str, seed: int = 0, tie: bool = False,
               model: str = "debug-tiny"):
    jcfg = dataclasses.replace(jconfig.get_config(model),
                               dtype=_DT[dtype][0], tie_word_embeddings=tie)
    tcfg = dataclasses.replace(tconfig.get_config(model),
                               dtype=_DT[dtype][1], tie_word_embeddings=tie)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("tie", [False, True])
def test_params_from_jax_round_trip(tie):
    """bf16 weights through float32 come back bit for bit."""
    _, tcfg, _, np_params = _jax_model("bfloat16", seed=1, tie=tie)
    model = params_from_jax(np_params, tcfg, device="cpu")
    assert ("lm_head" in dict(model.named_parameters())) == (not tie)
    for name, p in model.named_parameters():
        src = (np_params["layers"][name] if name in tllama.LAYER_KEYS
               else np_params[name])
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(src, np.float32))


def test_gemma2_params_from_jax_round_trip():
    """Gemma-2's sandwich norms come across with the rest, bit for bit,
    and its norm gains start at zeros on both sides (rms_norm_offset)."""
    _, tcfg, _, np_params = _jax_model("bfloat16", seed=1, tie=True,
                                       model="debug-gemma2")
    model = params_from_jax(np_params, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert {"post_attn_norm", "post_mlp_norm"} <= set(names)
    for name, p in names.items():
        src = (np_params["layers"][name] if name in tllama.LAYER_KEYS
               else np_params[name])
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(src, np.float32))
    fresh = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    for name in ("attn_norm", "post_attn_norm", "mlp_norm",
                 "post_mlp_norm", "final_norm"):
        assert not getattr(fresh, name).any()
        assert not np.asarray(np_params["layers"].get(
            name, np_params.get(name)), np.float32).any()


def test_unsupported_families_raise():
    """The port builds every family the JAX package serves (MoE, q/k/v
    biases, a window on every layer); what both refuse, a family outside
    the Llama line or a Qwen2-MoE with dense layers between its sparse
    ones, raises in the port's config as in the JAX one."""
    for preset in ("debug-sliding", "debug-moe", "qwen2-7b",
                   "qwen1.5-moe-a2.7b", "mixtral-8x7b", "mistral-7b-v0.1"):
        full = tconfig.get_config(preset)
        cfg = dataclasses.replace(
            full, num_layers=1, vocab_size=64, hidden_size=32,
            intermediate_size=32, head_dim=8,
            moe_intermediate_size=16 if full.moe_intermediate_size else None,
            shared_expert_size=16 if full.shared_expert_size else 0)
        names = dict(tllama.Llama(cfg, device="cpu").named_parameters())
        assert ("router" in names) == bool(cfg.num_experts)
        assert ("q_bias" in names) == cfg.attention_bias
    for bad in ({"model_type": "bert", "vocab_size": 64, "hidden_size": 32,
                 "intermediate_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 2},
                {"model_type": "qwen2_moe", "vocab_size": 64,
                 "hidden_size": 32, "intermediate_size": 64,
                 "num_hidden_layers": 4, "num_attention_heads": 2,
                 "num_experts": 4, "decoder_sparse_step": 2}):
        for mc in (tconfig.ModelConfig, jconfig.ModelConfig):
            with pytest.raises(ValueError):
                mc.from_hf_config(bad)


def test_gemma2_served_and_every_layer_window_refused():
    """Gemma-2 (a window on alternating layers) builds with its window
    on the even layers only; the same model with a window on every layer
    (Mistral v0.1's pattern, whose engine frees blocks behind the
    window) is no longer refused: every layer takes the window, as the
    JAX forward windows it."""
    cfg = tconfig.get_config("debug-gemma2")
    tllama.Llama(cfg, device="cpu")
    assert [tllama.layer_window(cfg, l) for l in range(4)] == [64, 0, 64, 0]
    every = dataclasses.replace(cfg, alternating_sliding=False)
    tllama.Llama(every, device="cpu")
    assert [tllama.layer_window(every, l) for l in range(4)] == [64] * 4


@pytest.mark.parametrize("dtype,tie", [("float32", False),
                                       ("float32", True),
                                       ("bfloat16", False)])
def test_forward_prefill_then_decode_matches_jax(dtype, tie):
    jcfg, tcfg, jparams, np_params = _jax_model(dtype, seed=2, tie=tie)
    model = params_from_jax(np_params, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    B, Bs, MB, N = 3, 8, 6, 24
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=_DT[dtype][0])
    tcache, ttables = cache_from_jax(np.asarray(jcache.k),
                                     np.asarray(jcache.v), tables,
                                     dtype=_DT[dtype][1], device="cpu")
    atol = 1e-4 if dtype == "float32" else None

    def check(tokens, positions, valid, kv_len):
        nonlocal jcache
        jl, jcache = jllama.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jcache, block_tables=jnp.asarray(tables), kv_len=kv_len,
            token_valid=jnp.asarray(valid))
        tl, _ = tllama.forward(
            model, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, block_tables=ttables,
            kv_len=kv_len, token_valid=torch.from_numpy(valid))
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.dtype == np.float32
        tol = atol if atol is not None else 5e-2 * np.abs(jl).max()
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=0, atol=tol)

    # prefill: ragged prompts right-padded to a 12-token chunk
    T = 12
    lens = np.array([12, 7, 10], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = np.arange(T)[None, :] < lens[:, None]
    check(tokens, positions, valid, kv_len=16)
    # decode steps, each row at its own position
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = (lens + step)[:, None].astype(np.int32)
        check(tok, pos, np.ones((B, 1), bool), kv_len=24)
    if dtype == "float32":
        # the pools hold the same K/V outside trash block 0
        np.testing.assert_allclose(tcache.k.numpy()[:, 1:],
                                   np.asarray(jcache.k)[:, 1:],
                                   rtol=0, atol=1e-5)


def test_gemma2_forward_past_the_window_matches_jax():
    """debug-gemma2 in float32 (window 64 on layer 0, softcaps, sandwich
    norms, query_pre_attn_scalar, embedding scale, gelu_tanh): two
    prefill chunks to position 80, then decode steps to 86, so the
    sliding layer drops keys the global layer keeps. Logits to 1e-4."""
    jcfg, tcfg, jparams, np_params = _jax_model("float32", seed=5,
                                                tie=True,
                                                model="debug-gemma2")
    model = params_from_jax(np_params, tcfg, device="cpu")
    rng = np.random.default_rng(8)
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    B, Bs, MB, N = 2, 16, 8, 20
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(L, N, Bs, Hkv, D, dtype=jnp.float32)
    tcache, ttables = cache_from_jax(np.asarray(jcache.k),
                                     np.asarray(jcache.v), tables,
                                     dtype=torch.float32, device="cpu")

    def check(tokens, positions, kv_len):
        nonlocal jcache
        jl, jcache = jllama.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jcache, block_tables=jnp.asarray(tables), kv_len=kv_len)
        tl, _ = tllama.forward(
            model, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, block_tables=ttables,
            kv_len=kv_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)

    for lo, hi in ((0, 40), (40, 80)):
        tokens = rng.integers(0, jcfg.vocab_size, (B, hi - lo)).astype(
            np.int32)
        positions = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                    (B, hi - lo)).copy()
        check(tokens, positions, kv_len=hi)
    for pos in range(80, 86):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        check(tok, np.full((B, 1), pos, np.int32), kv_len=96)


def test_gemma1_conventions_match_jax():
    """Gemma-1's conventions (embedding scale, RMS offset with zero-init
    gains, gelu_tanh, tied head; no window, softcap or sandwich norms)
    on debug-gemma2's shapes, in float32: a prefill chunk, then decode
    steps; logits to 1e-4."""
    gemma1 = dict(sliding_window=None, alternating_sliding=False,
                  attn_logit_softcap=None, final_logit_softcap=None,
                  query_pre_attn_scalar=None, sandwich_norms=False)
    jcfg = dataclasses.replace(jconfig.get_config("debug-gemma2"),
                               dtype=jnp.float32, **gemma1)
    tcfg = dataclasses.replace(tconfig.get_config("debug-gemma2"),
                               dtype=torch.float32, **gemma1)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(6))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            tcfg, device="cpu")
    assert not hasattr(model, "post_attn_norm")
    rng = np.random.default_rng(9)
    B, Bs, MB, N = 2, 8, 4, 12
    tables = (rng.permutation(N - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    jcache = jkv.make_cache(jcfg.num_layers, N, Bs, jcfg.num_kv_heads,
                            jcfg.head_dim_, dtype=jnp.float32)
    tcache, ttables = cache_from_jax(np.asarray(jcache.k),
                                     np.asarray(jcache.v), tables,
                                     dtype=torch.float32, device="cpu")
    for lo, hi in ((0, 12), (12, 13), (13, 14)):
        tokens = rng.integers(0, jcfg.vocab_size, (B, hi - lo)).astype(
            np.int32)
        positions = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                    (B, hi - lo)).copy()
        jl, jcache = jllama.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jcache, block_tables=jnp.asarray(tables), kv_len=16)
        tl, _ = tllama.forward(
            model, tcfg, torch.from_numpy(tokens),
            torch.from_numpy(positions), tcache, block_tables=ttables,
            kv_len=16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)


def test_forward_last_index_equals_full_logits_row():
    """The serving runner asks for logits at one position per row; they
    equal that row of the full logits."""
    _, tcfg, _, np_params = _jax_model("float32", seed=3)
    model = params_from_jax(np_params, tcfg, device="cpu")
    cache, tables = tkv.make_slot_cache(tcfg.num_layers, 2, 32,
                                        tcfg.num_kv_heads, tcfg.head_dim_,
                                        dtype=torch.float32, block_size=8,
                                        device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    positions = torch.arange(9)[None, :].repeat(2, 1)
    full, _ = tllama.forward(model, tcfg, tokens, positions, cache,
                             block_tables=tables, kv_len=16)
    last = torch.tensor([8, 4])
    one, _ = tllama.forward(model, tcfg, tokens, positions, cache,
                            block_tables=tables, kv_len=16,
                            last_index=last)
    assert one.shape == (2, 1, tcfg.vocab_size)
    torch.testing.assert_close(one[:, 0], full[torch.arange(2), last],
                               rtol=1e-5, atol=1e-5)
