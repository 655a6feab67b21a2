"""The port's aggregation engine (Eq. 1) against the JAX reference engine.

Same numpy inputs on both sides.  Tolerance for float results: fp32,
rtol=atol=1e-6 (the same products summed in another order); masks,
layouts and byte counts must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import agg_engine as J  # noqa: E402
from repro_torch.core import agg_engine as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _stacked_tree(s, seed=0):
    """A small site-stacked tree with the nesting SA-Net uses (dicts of
    lists of dicts) and ragged leaf sizes."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.normal(size=(s,) + shape).astype(np.float32)
    return {"stem": {"w": r(3, 3, 2, 5), "b": r(5)},
            "enc": [{"b1": {"scale": r(7)}, "down": {"w": r(1, 1, 7, 3)}},
                    {"b1": {"scale": r(1)}}],
            "head": r(11)}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("with_scale", [False, True])
def test_normalized_weights(with_scale):
    rng = np.random.default_rng(1)
    cw = rng.dirichlet(np.ones(5)).astype(np.float32)
    active = np.array([True, False, True, True, False])
    scale = rng.uniform(1, 3, 5).astype(np.float32) if with_scale else None
    want = J.normalized_weights(jnp.asarray(cw), jnp.asarray(active),
                                None if scale is None else jnp.asarray(scale))
    got = T.normalized_weights(torch.from_numpy(cw), active,
                               None if scale is None else torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[1]) == 0.0 and float(got[4]) == 0.0


@pytest.mark.parametrize("active", [[True, True, True], [True, False, True],
                                    [False, False, True]])
def test_aggregate_masked_round_matches_reference(active):
    tree = _stacked_tree(3)
    jt, tt = _both(tree)
    cw = np.array([0.2, 0.5, 0.3], np.float32)
    jnew, jglob = J.AggregationEngine().aggregate(jt, jnp.asarray(cw),
                                                  jnp.asarray(active))
    tnew, tglob = T.AggregationEngine().aggregate(tt, torch.from_numpy(cw),
                                                  np.array(active))
    for a, b in zip(jax.tree.leaves(jglob), tree_leaves(tglob)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for a, b, orig in zip(jax.tree.leaves(jnew), tree_leaves(tnew),
                          tree_leaves(tree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        # inactive sites keep their local weights bit for bit
        for i, on in enumerate(active):
            if not on:
                assert np.array_equal(b[i].numpy(), orig[i])


def test_aggregate_flat_in_place_equals_tree_path():
    tree = _stacked_tree(4, seed=3)
    _, tt = _both(tree)
    cw = torch.full((4,), 0.25)
    active = np.array([True, False, True, False])
    eng = T.AggregationEngine()
    new_tree, glob = eng.aggregate(tt, cw, active)
    flat, layout = eng.flatten(tt)
    gflat = eng.aggregate_flat(flat, cw, active)
    assert torch.equal(flat, eng.flatten(new_tree)[0])
    for a, b in zip(tree_leaves(eng.unflatten(gflat, layout)), tree_leaves(glob)):
        assert torch.equal(a, b)


def test_flatten_layout_and_bytes_match_reference():
    tree = _stacked_tree(2, seed=5)
    jt, tt = _both(tree)
    jeng, teng = J.AggregationEngine(), T.AggregationEngine()
    jflat, jlay = jeng.flatten(jt)
    tflat, tlay = teng.flatten(tt)
    # same leaf order, so the raveled buffers are identical
    assert np.array_equal(tflat.numpy(), np.asarray(jflat))
    assert tlay.offsets == jlay.offsets and tlay.n == jlay.n
    assert tlay.shapes == tuple(tuple(s) for s in jlay.shapes)
    assert T.per_site_nbytes(tt) == J.per_site_nbytes(jt)
    for i in range(2):                       # each row unflattens to its site
        back = teng.unflatten(tflat[i], tlay)
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            assert np.array_equal(a.numpy(), b[i])
    assert teng.layout_of(tt) is tlay        # cached per structure/shape/dtype


def test_global_mean_matches_reference():
    tree = _stacked_tree(3, seed=9)
    jt, tt = _both(tree)
    w = np.array([0.1, 0.6, 0.3], np.float32)
    want = J.AggregationEngine().global_mean(jt, jnp.asarray(w))
    got = T.get_engine().global_mean(tt, torch.from_numpy(w))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
