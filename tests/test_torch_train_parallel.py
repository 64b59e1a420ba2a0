"""The port's parallel training (parallel/mesh.TrainWorld,
ring_attention.py, train.jit_train_step, pipeline.py) against the JAX
package on the CPU, in float32, ranks as threads over one gloo store
(parallel/dryrun.run_world) and JAX on its 8-device virtual mesh.

- Ring attention at sp = 8 against the port's dense causal attention
  and JAX's ring attention: outputs within 2e-5, the q/k/v gradients
  (every rank's block, gathered) within atol 2e-5 / rtol 2e-4 of the
  dense attention's.
- The dp 2 x sp 2 x tp 2 step's losses within 1e-4 of JAX's
  jit_train_step on the same mesh; the first-step loss at sp = 4
  against dp = 4 within 1e-4 (tests/test_parallel.py's case).
- tp = 2 against tp = 1 where the gradient's norm clips: the clipped
  gradients (the first mu over 1 - b1), each rank's slice within 1e-5,
  on the test_parallel CFG, debug-moe (the router's partial gradient)
  and debug-gemma2 (the tied vocab-parallel head).
- GPipe at pp = 4 with 1 and 4 microbatches: the loss within 1e-4 and
  every gradient within atol 2e-4 / rtol 2e-3 of the plain ones
  (tests/test_pipeline.py's tolerances).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.attention import \
    causal_attention as jcausal_attention
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import train as jtrain
from production_stack_tpu.parallel.ring_attention import \
    ring_causal_attention as jring
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.attention import causal_attention
from production_stack_tpu_torch.parallel import (dryrun, pipeline,
                                                 sharding, train)
from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard
from production_stack_tpu_torch.parallel.ring_attention import \
    ring_causal_attention
from production_stack_tpu_torch.weights import params_from_jax

CFG = dict(name="t", vocab_size=128, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=8, num_kv_heads=4,
           max_position_embeddings=256)
PP_CFG = dict(name="t-pp", vocab_size=128, hidden_size=64,
              intermediate_size=128, num_layers=4, num_heads=4,
              num_kv_heads=2, max_position_embeddings=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(fields, seed=0):
    jcfg = jconfig.ModelConfig(**fields, dtype=jnp.float32)
    tcfg = tconfig.ModelConfig(**fields, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _jax_mesh(**axes):
    cfg = jmesh.MeshConfig(**axes)
    return jmesh.build_mesh(cfg, jax.devices()[:cfg.size])


# ------------------------------------------------------------ ring attention

def _ring_rank(world, q, k, v, dout):
    """This rank's block through ring attention, and the gradients of
    sum(out * dout) w.r.t. its q/k/v blocks."""
    n, i = world.size("sp"), world.index("sp")
    Tl = q.shape[1] // n
    blk = slice(i * Tl, (i + 1) * Tl)
    ql, kl, vl = (t[:, blk].clone().requires_grad_() for t in (q, k, v))
    out = ring_causal_attention(ql, kl, vl, world)
    grads = torch.autograd.grad((out * dout[:, blk]).sum(), (ql, kl, vl))
    return out.detach(), grads


def test_ring_attention_matches_dense_and_jax():
    rng = np.random.default_rng(1)
    B, T, H, Hkv, D = 2, 64, 4, 2, 16
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, H, D)))
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            _jax_mesh(sp=8)))
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    ranks = dryrun.run_world(MeshConfig(sp=8), "cpu", _ring_rank, tq, tk,
                             tv, tdout)
    out = torch.cat([r[0] for r in ranks], dim=1)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    dq, dk, dv = (leaf.clone().requires_grad_() for leaf in (tq, tk, tv))
    dense = causal_attention(dq, dk, dv)
    np.testing.assert_allclose(out.numpy(), dense.detach().numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        dense.detach().numpy(),
        np.asarray(jcausal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad((dense * tdout).sum(), (dq, dk, dv))
    for j, name in enumerate("qkv"):
        got = torch.cat([r[1][j] for r in ranks], dim=1)
        np.testing.assert_allclose(got.numpy(), grads[j].numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=name)


# ------------------------------------------------------------- sharded step

def _step_rank(world, tcfg, np_params, tokens, steps, sp):
    model = params_from_jax(np_params, tcfg, "cpu")
    state, step_fn = train.jit_train_step(world, tcfg, model,
                                          sequence_parallel=sp)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
    return losses, state, dict(world.calls)


def _jax_losses(mesh, jcfg, seed, tokens, steps):
    # params are consumed by jit_train_step: a fresh draw per mesh
    state, step = jtrain.jit_train_step(
        mesh, jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(seed)))
    out = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(tokens))
        out.append(float(loss))
    return out


def test_dp_sp_tp_step_losses_match_jax():
    jcfg, tcfg, _, np_params = _pair(CFG)
    tokens = np.random.default_rng(3).integers(0, 128, (4, 32)).astype(
        np.int64)
    want = _jax_losses(_jax_mesh(dp=2, sp=2, tp=2), jcfg, 0, tokens, 3)
    ranks = dryrun.run_world(MeshConfig(dp=2, sp=2, tp=2), "cpu",
                             _step_rank, tcfg, np_params,
                             torch.from_numpy(tokens), 3, True)
    losses = ranks[0][0]
    assert all(r[0] == losses for r in ranks)
    np.testing.assert_allclose(losses, want, atol=1e-4, rtol=0)
    assert losses[-1] < losses[0]
    # per step: 2 ring hops a layer each way, the tp collectives of
    # both passes, and the dp x sp sum of every leaf and of the loss
    calls = ranks[0][2]
    assert calls["sp.shift"] == 3 * 2 * 2
    assert calls["data.all_reduce"] == 3 * (len(tllama.leaf_shapes(tcfg))
                                            + 1)


def test_sp_step_matches_dp_loss():
    """The first-step loss of a sequence split over sp = 4 (ring
    attention) equals dp = 4's, and JAX's at both."""
    jcfg, tcfg, _, np_params = _pair(CFG)
    tokens = np.random.default_rng(4).integers(0, 128, (4, 64)).astype(
        np.int64)
    got = {}
    for axes in (dict(dp=4, tp=2), dict(sp=4, tp=2)):
        ranks = dryrun.run_world(MeshConfig(**axes), "cpu", _step_rank,
                                 tcfg, np_params, torch.from_numpy(tokens),
                                 1, True)
        got[tuple(axes)] = ranks[0][0][0]
        want = _jax_losses(_jax_mesh(**axes), jcfg, 0, tokens, 1)[0]
        assert abs(got[tuple(axes)] - want) < 1e-4
    assert abs(got[("dp", "tp")] - got[("sp", "tp")]) < 1e-4


def _clipped_rank(world, tcfg, np_params, tokens):
    _, state, _ = _step_rank(world, tcfg, np_params, tokens, 1, False)
    return {n: m / (1 - 0.9) for n, m in state.opt_state.mu.items()}


@pytest.mark.parametrize("model", ["t", "debug-moe", "debug-gemma2"])
def test_tp_clipped_gradients_equal_one_rank(model):
    """A tp = 2 step's clipped gradient (the first moment over 1 - b1)
    equals tp = 1's where the norm clips: the sharded leaves' squares are
    summed over tp, the replicated ones counted once. debug-moe (at
    capacity factor 0.5: the dispatch) adds the router, whose gradient
    is a partial sum over tp; debug-gemma2 the tied vocab-parallel head,
    the softcaps and the sandwich norms."""
    if model == "t":
        _, tcfg, _, np_params = _pair(CFG)
    else:
        jcfg = dataclasses.replace(jconfig.get_config(model),
                                   dtype=jnp.float32, moe_capacity_factor=0.5)
        tcfg = dataclasses.replace(tconfig.get_config(model),
                                   dtype=torch.float32,
                                   moe_capacity_factor=0.5)
        np_params = jax.tree_util.tree_map(
            np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (4, 32)).astype(np.int64))
    full = train.trainable(params_from_jax(np_params, tcfg, "cpu"))
    grads = dict(zip([n for n, _ in full.named_parameters()],
                     torch.autograd.grad(train.loss_fn(full, tcfg, tokens),
                                         list(full.parameters()))))
    norm = float(train.global_norm(grads))
    assert norm > 1.0, "the case must clip"
    one = dryrun.run_world(MeshConfig(), "cpu", _clipped_rank, tcfg,
                           np_params, tokens)[0]
    for name, g in grads.items():
        np.testing.assert_allclose(one[name].numpy(), g.numpy() / norm,
                                   atol=1e-6, rtol=1e-4, err_msg=name)
    two = dryrun.run_world(MeshConfig(tp=2), "cpu", _clipped_rank, tcfg,
                           np_params, tokens)
    for name, want in one.items():
        spec = sharding.leaf_spec(tcfg, name)
        for r in range(2):
            np.testing.assert_allclose(
                two[r][name].numpy(),
                sharding.slice_spec(want, spec, Shard(tp=2, tp_rank=r))
                .numpy(), atol=1e-5, rtol=0, err_msg=name)


# ------------------------------------------------------------------- GPipe

def _pp_rank(world, tcfg, np_params, tokens, n_micro):
    full = params_from_jax(np_params, tcfg, "cpu")
    stage = train.trainable(pipeline.stage_params(
        full, world.size("pp"), world.index("pp")))
    loss = pipeline.pipeline_loss_fn(tcfg, world, n_micro)(stage, tokens)
    names = [n for n, _ in stage.named_parameters()]
    grads = torch.autograd.grad(loss, list(stage.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("n_micro", [1, 4])
def test_gpipe_loss_and_gradients_match_plain(n_micro):
    jcfg, tcfg, jparams, np_params = _pair(PP_CFG)
    tokens = np.random.default_rng(1).integers(0, 128, (8, 32)).astype(
        np.int64)
    full = train.trainable(params_from_jax(np_params, tcfg, "cpu"))
    plain = train.loss_fn(full, tcfg, torch.from_numpy(tokens))
    want = dict(zip([n for n, _ in full.named_parameters()],
                    torch.autograd.grad(plain, list(full.parameters()))))
    assert abs(float(plain.detach()) - float(jtrain.loss_fn(
        jparams, jcfg, jnp.asarray(tokens)))) < 1e-5
    stages = dryrun.run_world(MeshConfig(pp=4), "cpu", _pp_rank, tcfg,
                              np_params, torch.from_numpy(tokens), n_micro)
    for loss, _ in stages:
        assert abs(loss - float(plain.detach())) < 1e-4
    for name, w in want.items():
        if name in tllama.LAYER_KEYS:
            got = torch.cat([g[name] for _, g in stages])
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=2e-4,
                                       rtol=2e-3, err_msg=name)
        else:
            # replicated: summed over pp, so every stage holds it whole
            for _, g in stages:
                np.testing.assert_allclose(g[name].numpy(), w.numpy(),
                                           atol=2e-4, rtol=2e-3,
                                           err_msg=name)
