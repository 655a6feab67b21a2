"""The port's SA-Net against the JAX reference.

Parameters come from the reference's init through ``repro_torch.convert``;
inputs are numpy arrays from a seed fed to both.  Small sizes: 16^3
volumes, ``base_filters=8``, 3 levels (so scale attention both down- and
upsamples).  Tolerances: the forward pass and losses agree to fp32
round-off of a deep conv stack (rtol 1e-5, atol 1e-4 on outputs of order
10); gradients per leaf to rtol 1e-4 plus an atol of 1e-5 of the largest
gradient, since a conv bias feeding a GroupNorm has a true gradient of 0
and both sides return round-off there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import sanet_openkbp as jconfigs  # noqa: E402
from repro.models import sanet as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import sanet_openkbp as tconfigs  # noqa: E402
from repro_torch.models import sanet as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

CFG = dict(in_channels=4, out_channels=1, base_filters=8, num_levels=3)


def _jax_init(seed, cfg):
    """The reference's init, jitted: eager, each leaf's random op compiles
    on its own, which takes most of this file's time on the CPU."""
    return jax.jit(J.sanet_init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = J.SANetConfig(**CFG), T.SANetConfig(**CFG)
    jp = _jax_init(3, jcfg)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    batch = {"volume": rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32),
             "dose": rng.random((2, 16, 16, 16, 1)).astype(np.float32),
             "mask": (rng.random((2, 16, 16, 16, 1)) > 0.3).astype(np.float32)}
    return jcfg, tcfg, jp, tp, batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_matches_reference(setup):
    jcfg, tcfg, jp, tp, batch = setup
    jout, jds = jax.jit(lambda p, x: J.sanet_apply(p, x, jcfg))(jp, batch["volume"])
    tout, tds = T.sanet_apply(tp, torch.from_numpy(batch["volume"]), tcfg)
    assert tout.shape == (2, 16, 16, 16, 1) and len(tds) == len(jds) == 2
    for a, b in zip(jds, tds):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-4)


def test_dose_loss_and_gradients_match_reference(setup):
    jcfg, tcfg, jp, tp, batch = setup
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: J.dose_loss(p, b, jcfg), has_aux=True))(jp, batch)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    tl, _ = T.dose_loss(tree_unflatten(tp, leaves), _t(batch), tcfg)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = tree_leaves(convert.from_reference(jax.tree.map(np.asarray, jg)))
    scale = max(float(w.abs().max()) for w in want)
    for w, g in zip(want, tg):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale)


def test_segmentation_loss_matches_reference():
    cfg = dict(in_channels=2, out_channels=3, base_filters=8, num_levels=2,
               task="segmentation")
    jcfg, tcfg = J.SANetConfig(**cfg), T.SANetConfig(**cfg)
    jp = _jax_init(1, jcfg)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    batch = {"volume": rng.normal(size=(1, 8, 8, 8, 2)).astype(np.float32),
             "labels": rng.integers(0, 3, (1, 8, 8, 8)).astype(np.int32)}
    for focal in (False, True):
        jl, _ = jax.jit(lambda p, b: J.segmentation_loss(p, b, jcfg, use_focal=focal))(
            jp, batch)
        tl, _ = T.segmentation_loss(tp, _t(batch), tcfg, use_focal=focal)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("src,dst", [(16, 8), (8, 16), (4, 16), (16, 4), (6, 4)])
def test_nearest_resize_picks_the_reference_voxels(src, dst):
    """jax.image.resize 'nearest' samples half-pixel centres (16->8 keeps
    voxels 1, 3, 5, ...): the port must pick the same voxels exactly."""
    x = np.arange(2 * src ** 3 * 3, dtype=np.float32).reshape(2, src, src, src, 3)
    want = J.resize_volume(jnp.asarray(x), (dst,) * 3)
    got = T.resize_volume(torch.from_numpy(x).permute(0, 4, 1, 2, 3), (dst,) * 3)
    assert np.array_equal(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("size,stride,k", [(16, 2, 3), (15, 2, 3), (8, 1, 3),
                                           (7, 1, 1), (9, 2, 1)])
def test_same_padding_matches_reference_conv(size, stride, k):
    """XLA's 'SAME' with stride 2 pads (0, 1) on even sizes; torch's
    symmetric padding=1 would shift every window."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(1, size, size, size, 3)).astype(np.float32)
    p = J.conv_init(jax.random.PRNGKey(0), (k, k, k), 3, 4)
    p = {"w": p["w"], "b": jnp.asarray(rng.normal(size=4).astype(np.float32))}
    want = J.conv_apply(p, jnp.asarray(x), stride=stride)
    got = T.conv_apply(convert.from_reference(jax.tree.map(np.asarray, p)),
                       torch.from_numpy(x).permute(0, 4, 1, 2, 3), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_init_structure_matches_reference_and_converts_back(setup):
    jcfg, tcfg, jp, tp, _ = setup
    mine = T.sanet_init(torch.Generator().manual_seed(0), tcfg)
    ref_shapes = [a.shape for a in tree_leaves(convert.from_reference(
        jax.tree.map(np.asarray, jp)))]
    assert [t.shape for t in tree_leaves(mine)] == ref_shapes
    assert tree_map(lambda _: None, mine) == tree_map(lambda _: None, tp)
    back = convert.to_reference(tp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b)


def test_full_width_config_matches_reference():
    assert vars(tconfigs.SANET) == vars(jconfigs.SANET)
    assert vars(tconfigs.reduced()) == vars(jconfigs.reduced())
    n = sum(t.numel() for t in tree_leaves(
        T.sanet_init(torch.Generator().manual_seed(0), tconfigs.SANET)))
    assert n == 6_844_323
