"""Parity of the PyTorch port's model with the JAX package's on the CPU:
the configuration table, carrying weights across, and the Llama forward
through the paged pool (a prefill chunk, then decode steps).

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


def _jax_model(dtype: str, seed: int = 0, tie: bool = False):
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=_DT[dtype][0], tie_word_embeddings=tie)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
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


def test_unsupported_families_raise():
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tllama.Llama(tconfig.get_config("debug-sliding"))
    with pytest.raises(NotImplementedError, match="num_experts"):
        tllama.Llama(tconfig.get_config("debug-moe"))


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
