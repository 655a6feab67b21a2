"""The port's functional AdamW and clipping against the JAX reference.

Same numpy parameters, gradients and moments on both sides.  Both run
the same fp32 operations in the same order per element, so results
agree to an ulp or two: rtol 1e-6, atol 1e-9 (updates are ~1e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as J  # noqa: E402
from repro_torch.optim import optimizers as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-9)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": (rng.normal(size=(3, 4, 5)) * scale).astype(np.float32),
                     "b": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "heads": [(rng.normal(size=(7,)) * scale).astype(np.float32)]}


def _close(torch_tree, jax_tree):
    for t, j in zip(tree_leaves(torch_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_reference(steps):
    params, wd, lr = _tree(0), 0.01, 1e-3
    jopt, topt = J.adamw(lr, weight_decay=wd), T.adamw(lr, weight_decay=wd)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(steps):
        g = _tree(100 + k, scale=1e-2)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        _close(tu, ju)
        jp, tp = J.apply_updates(jp, ju), T.apply_updates(tp, tu)
        _close(tp, jp)
    _close(ts["mu"], js["mu"])
    _close(ts["nu"], js["nu"])
    assert int(ts["step"]) == int(js["step"]) == steps


def test_adamw_on_a_flat_row_equals_the_tree():
    """The round loop updates a site's flat [N] row: same numbers as
    the per-leaf update."""
    params, grads = _tree(1), _tree(2, scale=1e-2)
    opt = T.adamw(1e-3, weight_decay=0.01)
    tp, tg = tree_map(torch.from_numpy, params), tree_map(torch.from_numpy, grads)
    tu, _ = opt.update(tg, opt.init(tp), tp)
    flat = lambda t: torch.cat([x.reshape(-1) for x in tree_leaves(t)])
    fu, _ = opt.update(flat(tg), opt.init(flat(tp)), flat(tp))
    assert torch.equal(fu, flat(tu))


@pytest.mark.parametrize("max_norm", [0.05, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3, scale=0.1)
    jc, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = T.clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tc, jc)
