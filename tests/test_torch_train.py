"""The port's training path (models/llama.forward_train,
parallel/train.py) against the JAX package's on the CPU, in float32.

Weights are drawn by JAX and carried across (weights.params_from_jax);
gradients and moments come back in JAX's layout (weights.to_jax), and
optax's state goes in (weights.opt_state_from_jax). Models: the CFG of
tests/test_parallel.py, debug-gemma2 (alternating windows of 64 passed
by a 72-token row, softcaps, sandwich norms, tied head) and debug-moe
at capacity factor 0.5 (192 tokens: the capacity dispatch, with drops).
Tolerances:
- logits 2e-5 and gradients atol 2e-5 / rtol 2e-4: the same float32
  arithmetic, summed in another order by two libraries;
- the loss of given unit-scale logits 1e-6: one log-softmax, two
  float32 ulps of a loss near ln V;
- AdamW updates rtol 1e-4 / atol 1e-8 of optax's, and the losses of 5
  train_steps 1e-5 of JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import quant as jquant
from production_stack_tpu.parallel import pipeline as jpipeline
from production_stack_tpu.parallel import train as jtrain
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import kv as tkv
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import quant as tquant
from production_stack_tpu_torch.parallel import dryrun, pipeline, train
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.weights import (opt_state_from_jax,
                                                params_from_jax, to_jax)

CFG = dict(name="t", vocab_size=128, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=8, num_kv_heads=4,
           max_position_embeddings=256)
# model -> (batch, sequence length)
SHAPES = {"t": (2, 16), "debug-gemma2": (2, 72), "debug-moe": (2, 96)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(model, seed=0):
    """(jcfg, tcfg, JAX params, numpy params), float32."""
    if model == "t":
        jcfg = jconfig.ModelConfig(**CFG, dtype=jnp.float32)
        tcfg = tconfig.ModelConfig(**CFG, dtype=torch.float32)
    else:
        jcfg = dataclasses.replace(jconfig.get_config(model),
                                   dtype=jnp.float32)
        tcfg = dataclasses.replace(tconfig.get_config(model),
                                   dtype=torch.float32)
    if model == "debug-moe":
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _tokens(model, seed=3):
    B, T = SHAPES[model]
    vocab = CFG["vocab_size"] if model == "t" else \
        tconfig.get_config(model).vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _leaves(tree):
    """(path, numpy leaf) of a JAX-layout params tree, sorted."""
    out = []
    for name, leaf in tree.items():
        if name == "layers":
            out += [(f"layers.{n}", np.asarray(v)) for n, v in leaf.items()]
        else:
            out.append((name, np.asarray(leaf)))
    return sorted(out)


def _assert_trees_close(got, want, atol, rtol):
    g, w = _leaves(got), _leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("model", list(SHAPES))
def test_forward_train_logits_match_jax(model):
    jcfg, tcfg, jparams, np_params = _pair(model)
    toks = _tokens(model)
    want = np.asarray(jllama.forward_train(jparams, jcfg, jnp.asarray(toks)))
    got = tllama.forward_train(params_from_jax(np_params, tcfg, "cpu"),
                               tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_nll_from_logits_matches_jax():
    """Unit-scale logits: a loss near ln 128, where 1e-6 is two float32
    ulps (the libraries' exp and log round differently)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 17, 128)).astype(np.float32)
    toks = rng.integers(0, 128, (3, 17)).astype(np.int32)
    want = float(jtrain.nll_from_logits(jnp.asarray(logits),
                                        jnp.asarray(toks)))
    got = float(train.nll_from_logits(torch.from_numpy(logits),
                                      torch.from_numpy(toks)))
    assert abs(got - want) < 1e-6


@pytest.mark.parametrize("model", list(SHAPES))
def test_gradients_match_jax(model):
    jcfg, tcfg, jparams, np_params = _pair(model)
    toks = _tokens(model)
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(jparams, jcfg,
                                                        jnp.asarray(toks))
    m = train.trainable(params_from_jax(np_params, tcfg, "cpu"))
    loss = train.loss_fn(m, tcfg, torch.from_numpy(toks))
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    _assert_trees_close(to_jax(dict(zip(names, grads))),
                        jax.tree_util.tree_map(np.asarray, jgrads),
                        atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("norm", [0.5, 5.0])
def test_optimizer_updates_match_optax(norm):
    """3 steps of make_optimizer on gradients of a given global norm
    (0.5: no clip; 5.0: clipped to 1): the first from zero moments on
    both sides, then from optax's state carried across. Each step's
    update (params after minus before) and the moments match optax's."""
    _, tcfg, jparams, np_params = _pair("t")
    opt = jtrain.make_optimizer()
    jstate = opt.init(jparams)
    tm = params_from_jax(np_params, tcfg, "cpu")
    tstate = train.init_train_state(tm).opt_state
    topt = train.make_optimizer()
    rng = np.random.default_rng(7)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            jparams)
        scale = norm / float(np.sqrt(sum(np.sum(np.square(x))
                                         for x in jax.tree.leaves(g))))
        g = jax.tree_util.tree_map(lambda x: x * np.float32(scale), g)
        updates, jstate = opt.update(g, jstate, jparams)
        new = optax.apply_updates(jparams, updates)
        want = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b), new, jparams)
        jparams = new
        params = dict(tm.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        tgrads = {n: torch.from_numpy(np.ascontiguousarray(
            g["layers"][n] if n in tllama.LAYER_KEYS else g[n]))
            for n in params}
        tstate = topt.update_(params, tgrads, tstate,
                              train.global_norm(tgrads))
        got = to_jax({n: p.detach() - before[n] for n, p in params.items()})
        _assert_trees_close(got, want, atol=1e-8, rtol=1e-4)
        adam = jstate[1][0]
        assert tstate.count == int(adam.count) == step + 1
        _assert_trees_close(to_jax(tstate.mu),
                            jax.tree_util.tree_map(np.asarray, adam.mu),
                            atol=1e-9, rtol=1e-5)
        if step == 0:
            # carry JAX's weights and state across: the next steps start
            # from optax's own moments
            np_now = jax.tree_util.tree_map(np.asarray, jparams)
            tm = params_from_jax(np_now, tcfg, "cpu")
            tstate = opt_state_from_jax(
                jax.tree_util.tree_map(np.asarray, jstate), tm)
            assert tstate.count == 1


def test_train_step_losses_match_jax():
    jcfg, tcfg, jparams, np_params = _pair("t")
    toks = _tokens("t")
    opt = jtrain.make_optimizer()
    jstate = jtrain.TrainState(jparams, opt.init(jparams),
                               jnp.zeros((), jnp.int32))
    state = train.init_train_state(params_from_jax(np_params, tcfg, "cpu"))
    topt = train.make_optimizer()
    want, got = [], []
    for _ in range(5):
        jstate, jl = jtrain.train_step(jstate, jnp.asarray(toks), jcfg, opt)
        state, loss = train.train_step(state, torch.from_numpy(toks), tcfg,
                                       topt)
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]
    assert state.step == 5


def test_a_consumed_state_refuses_a_second_step():
    _, tcfg, _, np_params = _pair("t")
    state = train.init_train_state(params_from_jax(np_params, tcfg, "cpu"))
    toks = torch.from_numpy(_tokens("t"))
    opt = train.make_optimizer()
    new, _ = train.train_step(state, toks, tcfg, opt)
    with pytest.raises(RuntimeError, match="consumed"):
        train.train_step(state, toks, tcfg, opt)
    train.train_step(new, toks, tcfg, opt)


def test_serving_weights_stay_frozen():
    """Training turns gradients on for its own module only: the
    constructors give frozen leaves, and a forward of a frozen model
    records no graph."""
    _, tcfg, _, np_params = _pair("t")
    served = params_from_jax(np_params, tcfg, "cpu")
    drawn = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    trained = train.trainable(params_from_jax(np_params, tcfg, "cpu"))
    assert not any(p.requires_grad for p in served.parameters())
    assert not any(p.requires_grad for p in drawn.parameters())
    assert all(p.requires_grad for p in trained.parameters())
    toks = torch.from_numpy(_tokens("t"))
    assert tllama.forward_train(served, tcfg, toks).grad_fn is None
    assert tllama.forward_train(trained, tcfg, toks).grad_fn is not None


def test_int8_leaves_refuse_training_as_jax_does():
    jcfg, tcfg, jparams, np_params = _pair("t")
    jq = jquant.quantize_params(jparams)
    opt = jtrain.make_optimizer()
    with pytest.raises(TypeError):
        jtrain.train_step(jtrain.TrainState(jq, opt.init(jq),
                                            jnp.zeros((), jnp.int32)),
                          jnp.asarray(_tokens("t")), jcfg, opt)
    m = tquant.quantize_params(params_from_jax(np_params, tcfg, "cpu"))
    for kind in (ValueError, TypeError):
        with pytest.raises(kind, match="int8"):
            train.init_train_state(m)


def test_pp_not_dividing_the_layers_refuses_as_jax_does():
    jcfg, tcfg, jparams, np_params = _pair("t")
    with pytest.raises(ValueError, match="divide"):
        jpipeline.stage_params(jparams, 3)
    m = params_from_jax(np_params, tcfg, "cpu")
    with pytest.raises(ValueError, match="divide"):
        pipeline.stage_params(m, 3, 0)
    stage = pipeline.stage_params(m, 2, 1)
    assert stage.cfg.num_layers == 1
    np.testing.assert_array_equal(stage.q.detach().numpy(),
                                  m.q.detach()[1:].numpy())


def test_the_configs_layers_run_not_the_models():
    """encode and forward run the first cfg.num_layers layers of a
    deeper model (a reference runs a model's first layer so): equal to
    the model cut to those layers."""
    _, tcfg, _, np_params = _pair("t")
    m = params_from_jax(np_params, tcfg, "cpu")
    first = pipeline.stage_params(m, 2, 0)
    cfg1 = first.cfg
    toks = torch.from_numpy(_tokens("t"))
    torch.testing.assert_close(tllama.encode(m, cfg1, toks),
                               tllama.encode(first, cfg1, toks))
    B, T = toks.shape
    pos = torch.arange(T)[None].expand(B, T)
    out = []
    for model in (m, first):
        cache, tables = tkv.make_slot_cache(1, B, T, cfg1.num_kv_heads,
                                            cfg1.head_dim_, torch.float32,
                                            device="cpu")
        out.append(tllama.forward(model, cfg1, toks, pos, cache,
                                  block_tables=tables)[0])
    torch.testing.assert_close(out[0], out[1])


def _refusal(world, fn, kind):
    with pytest.raises(kind):
        fn(world)
    return True


def test_sp_with_a_window_and_pp_with_alternating_windows_refuse():
    """JAX's refusals, with its exception types: sequence-parallel
    training of a windowed model, and a pipeline over Gemma-2's
    alternating windows."""
    jcfg, tcfg, jparams, np_params = _pair("debug-gemma2")
    from production_stack_tpu.parallel import mesh as jmesh
    sp_mesh = jmesh.build_mesh(jmesh.MeshConfig(sp=2), jax.devices()[:2])
    with pytest.raises(NotImplementedError):
        jtrain.jit_train_step(sp_mesh, jcfg, jparams)
    pp_mesh = jmesh.build_mesh(jmesh.MeshConfig(pp=2), jax.devices()[:2])
    with pytest.raises(NotImplementedError):
        jpipeline.pipeline_loss_fn(jcfg, pp_mesh, n_micro=2)
    model = params_from_jax(np_params, tcfg, "cpu")
    assert dryrun.run_world(
        MeshConfig(sp=2), "cpu", _refusal,
        lambda w: train.jit_train_step(w, tcfg, model),
        NotImplementedError) == [True, True]
    assert dryrun.run_world(
        MeshConfig(pp=2), "cpu", _refusal,
        lambda w: pipeline.pipeline_loss_fn(tcfg, w, 2),
        NotImplementedError) == [True, True]
