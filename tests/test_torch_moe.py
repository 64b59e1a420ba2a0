"""The port's ops/moe.py against the JAX package's ops/moe.py on the CPU,
in the setups of tests/test_moe.py: routing weights and expert ids, the
exact path, the capacity dispatch with and without drops, padding that
never takes capacity, the ``exact`` override, ``capacity_for``, and
int8 expert stacks.

Both sides take the same float32 inputs, drawn with numpy from a seed.
Tolerance: 1e-5 absolute on outputs of magnitude ~0.1-1, the same f32
arithmetic summed in another order by two libraries' matmuls. Expert
ids are compared exactly: torch.topk and lax.top_k could order equal
probabilities differently, and random inputs hold no ties, so a
difference fails the test instead of hiding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.models import quant as jquant
from production_stack_tpu.ops import moe as jmoe
from production_stack_tpu_torch.models import quant as tquant
from production_stack_tpu_torch.ops import moe as tmoe

ATOL = 1e-5


def _rand_moe(seed, N=96, h=32, E=4, i=64):
    """x [N, h], router [h, E], gate/up [E, h, i], down [E, i, h] float32
    (the scales of tests/test_moe.py)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (normal((N, h), 1.0), normal((h, E), 0.2),
            normal((E, h, i), 0.1), normal((E, h, i), 0.1),
            normal((E, i, h), 0.1))


def _both(arrays, **kw):
    """moe_mlp of JAX and of the port on the same arrays: (jax, port)."""
    valid = kw.pop("valid", None)
    j = jmoe.moe_mlp(*map(jnp.asarray, arrays), valid=None if valid is None
                     else jnp.asarray(valid), **kw)
    t = tmoe.moe_mlp(*map(torch.from_numpy, arrays), valid=None
                     if valid is None else torch.from_numpy(valid), **kw)
    return np.asarray(j), t.numpy()


def _dropped(arrays, capacity, valid=None, k=2):
    """The port's dropped assignments [N, k] (trash row, padding out)."""
    x, rw = arrays[:2]
    _, ids = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), k)
    dest = tmoe.dispatch_plan(ids, rw.shape[1], capacity, None
                              if valid is None else torch.from_numpy(valid))
    drop = (dest == rw.shape[1] * capacity).reshape(-1, k).numpy()
    if valid is not None:
        drop &= valid[:, None]
    return drop


@pytest.mark.parametrize("renormalize", [True, False])
def test_route_weights_and_ids_match_jax(renormalize):
    x, rw, *_ = _rand_moe(0)
    jw, ji = jmoe.route(jnp.asarray(x), jnp.asarray(rw), top_k=2,
                        renormalize=renormalize)
    tw, ti = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), top_k=2,
                        renormalize=renormalize)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    if renormalize:
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


def test_exact_path_matches_jax():
    arrays = _rand_moe(1)
    j, t = _both(arrays, top_k=2, dense_threshold=1000)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("factor,drops", [(1.6, False), (0.5, True)])
def test_dispatch_path_matches_jax_with_the_same_drops(factor, drops):
    """Capacity below N takes the dispatch branch. At factor 1.6 no
    assignment is dropped; at 0.5 some are, in token-major rank order.
    JAX's drop set is read from its output: a token whose assignment
    was dropped leaves the exact path's output by far more than the
    tolerance, so the tokens where JAX's output leaves the exact output
    are the tokens the port drops, and there the two outputs agree."""
    arrays = _rand_moe(2 if not drops else 3)
    N, E = arrays[0].shape[0], arrays[1].shape[1]
    cap = tmoe.capacity_for(N, E, 2, factor)
    assert cap == jmoe.capacity_for(N, E, 2, factor)
    assert cap < N, "capacity must not force the exact branch"
    j, t = _both(arrays, top_k=2, dense_threshold=1,
                 capacity_factor=factor)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    exact = _both(arrays, top_k=2, dense_threshold=1000)[0]
    drop = _dropped(arrays, cap)
    assert drop.any() == drops
    jax_dropped = np.abs(j - exact).max(axis=1) > 100 * ATOL
    np.testing.assert_array_equal(jax_dropped, drop.any(axis=1))
    if drops:
        # the fill is token-major: per expert the kept assignments are
        # the first `cap` in (token, choice) order
        _, ids = tmoe.route(*map(torch.from_numpy, arrays[:2]), 2)
        flat, kept = ids.reshape(-1).numpy(), ~drop.reshape(-1)
        for e in range(E):
            mine = np.flatnonzero(flat == e)
            np.testing.assert_array_equal(kept[mine],
                                          np.arange(len(mine)) < cap)


def test_padding_never_routes_or_takes_capacity():
    """valid=False rows output zeros and take no capacity: the real
    tokens' outputs equal JAX's and do not change with the padding's
    content."""
    arrays = _rand_moe(6)
    N = arrays[0].shape[0]
    valid = np.zeros(N, bool)
    valid[: N // 3] = True
    kw = dict(top_k=2, dense_threshold=1, capacity_factor=0.5, valid=valid)
    j, t = _both(arrays, **kw)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    assert (t[~valid] == 0).all()
    other = (arrays[0].copy(),) + arrays[1:]
    other[0][~valid] = 7.0
    t2 = _both(other, **kw)[1]
    # to ATOL, not bit for bit: the BLAS may split a product over another
    # number of threads in the second call, summing in another order
    np.testing.assert_allclose(t2[valid], t[valid], rtol=0, atol=ATOL)
    # the same real tokens alone: the padding took no slot from them
    cap = tmoe.capacity_for(N, 4, 2, 0.5)
    assert not _dropped(arrays, cap, valid)[~valid].any()
    j_ex, t_ex = _both(arrays, top_k=2, dense_threshold=1000, valid=valid)
    np.testing.assert_allclose(t_ex, j_ex, rtol=0, atol=ATOL)
    assert (t_ex[~valid] == 0).all()


def test_exact_flag_overrides_capacity():
    arrays = _rand_moe(7)
    j, t = _both(arrays, top_k=2, dense_threshold=1, capacity_factor=0.5,
                 exact=True)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    full = _both(arrays, top_k=2, dense_threshold=1000)[1]
    np.testing.assert_allclose(t, full, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,e,k,f", [(512, 8, 2, 1.0), (512, 8, 2, 100.0),
                                     (8, 8, 2, 1.0), (100, 8, 2, 1.0),
                                     (2048, 60, 4, 2.0), (88, 60, 4, 2.0),
                                     (4, 60, 4, 2.0), (96, 4, 2, 0.5)])
def test_capacity_for_matches_jax(n, e, k, f):
    assert tmoe.capacity_for(n, e, k, f) == jmoe.capacity_for(n, e, k, f)


@pytest.mark.parametrize("exact", [True, False])
def test_int8_expert_stacks_match_jax(exact):
    """Expert stacks quantized per expert and per output channel (scale
    [E, out]) by each package's quantize_tensor: bit-equal int8 and
    scales, and moe_mlp outputs equal JAX's (qwen2-style raw weights)."""
    x, rw, g, u, d = _rand_moe(8)
    jw = [jquant.quantize_tensor(jnp.asarray(w)) for w in (g, u, d)]
    tw = [tquant.quantize_tensor(torch.from_numpy(w)) for w in (g, u, d)]
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.w8.numpy(), np.asarray(a["w8"]))
        np.testing.assert_array_equal(b.scale.numpy(),
                                      np.asarray(a["scale"]))
    kw = dict(top_k=2, capacity_factor=0.5, renormalize=False,
              dense_threshold=1000 if exact else 1)
    j = jmoe.moe_mlp(jnp.asarray(x), jnp.asarray(rw), *jw, **kw)
    t = tmoe.moe_mlp(torch.from_numpy(x), torch.from_numpy(rw), *tw, **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
