"""The port of JAX's threefry stream (``repro_torch.core.prng``) against
``jax.random`` on the CPU.

- The key chain (``PRNGKey``, ``fold_in``, ``split``), ``bits`` and
  ``uniform`` are bit-equal over seeds, counters, shapes (0-d, odd sizes)
  and the chains the reference builds: DP's ``round_key`` and
  ``site_step_key``, the noise attack's ``_round_key``.  The uniforms are
  held on the ranges whose span is a power of two (``[0, 1)``, ``[-1, 1)``
  and the normal's ``(nextafter(-1, 0), 1)``), where ``f * span`` is exact:
  there XLA's contraction of ``f * span + lo`` into an FMA and the port's
  two roundings agree.
- ``normal`` is within 4 ulp of ``jax.random.normal`` and at least 95% of
  the draws are bit-equal (XLA's ``log1p`` and its FMA contractions round
  otherwise in the rest).
- A tree of per-leaf draws (DP's ``gaussian_noise_like``) lands in the
  port's layout: each conv leaf drawn at its DHWIO shape and transposed.
- The installed JAX draws with ``jax_threefry_partitionable`` on: the
  stream the port reproduces.  An upgrade that turns it off fails here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import adversary as jadv  # noqa: E402
from repro.privacy import dp as jdp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import adversary as tadv  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.privacy import dp as tdp  # noqa: E402

SEEDS = (0, 1, 13, 60013, 2 ** 31 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (2, 3, 4), (1025,))
ULP = 4


def _k(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulp distance of two fp32 arrays (their ordered integer images)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def test_installed_jax_draws_the_partitionable_stream():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    assert np.array_equal(_k(jk), tk.numpy())
    for d in (0, 1, 7, 13, 60013, 2 ** 31, 2 ** 32 - 1):
        assert np.array_equal(_k(jax.random.fold_in(jk, d)), prng.fold_in(tk, d).numpy())
    for n in (1, 2, 3, 17):
        assert np.array_equal(_k(jax.random.split(jk, n)), prng.split(tk, n).numpy())
    data = torch.tensor([0, 5, 2 ** 32 - 1])
    assert np.array_equal(prng.fold_in(tk, data).numpy(),
                          np.stack([_k(jax.random.fold_in(jk, int(d))) for d in data]))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_bit_equal(shape):
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
        jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        assert np.array_equal(jb, prng.bits(tk, shape).numpy())
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (float(np.nextafter(np.float32(-1), 0)), 1.0)):
            ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
            tu = prng.uniform(tk, shape, lo, hi).numpy()
            assert tu.shape == ju.shape and tu.dtype == np.float32
            assert np.array_equal(tu.view(np.int32), ju.view(np.int32))


def test_the_reference_chains_bit_equal():
    """DP's round and (site, step) keys, and the noise attack's round key,
    over rounds, sites and steps."""
    for seed in (0, 3):
        jcfg = jdp.DPConfig(clip=0.5, noise_multiplier=0.8, seed=seed)
        tcfg = tdp.DPConfig(clip=0.5, noise_multiplier=0.8, seed=seed)
        jplan = jadv.AdversaryPlan("noise", 1, 0.5, seed=seed)
        tplan = tadv.AdversaryPlan("noise", 1, 0.5, seed=seed)
        for rnd in (0, 1, 4, 99):
            jr, tr = jdp.round_key(jcfg, rnd), tdp.round_key(tcfg, rnd)
            assert np.array_equal(_k(jr), tr.numpy())
            assert np.array_equal(_k(jplan._round_key(rnd)), tplan._round_key(rnd).numpy())
            for site in (0, 3, 7):
                for step in (0, 1):
                    assert np.array_equal(_k(jdp.site_step_key(jr, site, step)),
                                          tdp.site_step_key(tr, site, step).numpy())


@pytest.mark.parametrize("seed", (0, 7))
def test_normal_within_4_ulp_and_mostly_bit_equal(seed):
    n = 1 << 18
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
    tn = prng.normal(prng.key(seed), (n,)).numpy()
    ulp = _ulps(jn, tn)
    assert int(ulp.max()) <= ULP
    assert float((ulp == 0).mean()) >= 0.95
    # the odd sizes and 0-d shapes of the uniforms, too
    for shape in SHAPES:
        jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        tn = prng.normal(prng.key(seed), shape).numpy()
        assert tn.shape == jn.shape and int(_ulps(jn, tn).max(initial=0)) <= ULP


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0])
    got = prng.erf_inv(x)
    assert torch.isinf(got[:2]).all() and bool((got[:2] * x[:2] > 0).all())
    assert float(got[2]) == 0.0


def test_noise_tree_in_the_ports_layout():
    """``gaussian_noise_like`` of a port tree (a 5-D conv leaf OIDHW, a
    bias, a matrix) is the reference's draw of the reference tree, each
    leaf transposed into the port's layout, within 4 ulp."""
    rng = np.random.default_rng(0)
    ref_tree = {"conv": {"w": rng.normal(size=(3, 3, 3, 2, 5)).astype(np.float32),
                         "b": np.zeros(5, np.float32)},
                "se": {"w1": np.zeros((5, 2), np.float32)}}
    jkey = jdp.site_step_key(jdp.round_key(jdp.DPConfig(clip=1.0, seed=4), 2), 1, 0)
    want = convert.from_reference(jax.tree.map(
        np.asarray, jdp.gaussian_noise_like(jkey, ref_tree, 0.4)))
    tkey = tdp.site_step_key(tdp.round_key(tdp.DPConfig(clip=1.0, seed=4), 2), 1, 0)
    got = tdp.gaussian_noise_like(tkey, convert.from_reference(ref_tree), 0.4)
    assert got["conv"]["w"].shape == (5, 2, 3, 3, 3)
    for path in (("conv", "w"), ("conv", "b"), ("se", "w1")):
        a, b = got[path[0]][path[1]].numpy(), want[path[0]][path[1]].numpy()
        assert int(_ulps(a, b).max()) <= ULP, path
