"""The port's Renyi accountant (``repro_torch.privacy.accountant``) against
the reference's: the same epsilon, bit for bit (both are the same float64
math on numpy), over a grid of (sigma, steps, delta, q), and the edge cases
and properties of the reference's ``tests/test_privacy.py``.  DPConfig's
validation raises the reference's errors."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.privacy import accountant as jacc  # noqa: E402
from repro.privacy import dp as jdp  # noqa: E402
from repro_torch.privacy import accountant as tacc  # noqa: E402
from repro_torch.privacy import dp as tdp  # noqa: E402

GRID = [(sigma, steps, delta) for sigma in (0.3, 0.8, 1.1, 2.0)
        for steps in (1, 6, 40, 100) for delta in (1e-5, 1e-6)]


@pytest.mark.parametrize("sigma,steps,delta", GRID)
def test_epsilon_equals_the_reference(sigma, steps, delta):
    assert tacc.gaussian_epsilon(sigma, steps, delta) == \
        jacc.gaussian_epsilon(sigma, steps, delta)
    assert tacc.analytic_gaussian_epsilon(sigma, steps, delta) == \
        jacc.analytic_gaussian_epsilon(sigma, steps, delta)


# the subsampled bound sums up to 257 terms at each of 255 orders in Python:
# a few (sigma, steps, delta, q) cover its regimes
@pytest.mark.parametrize("sigma,steps,delta,q", [(0.8, 6, 1e-5, 0.5), (1.1, 100, 1e-6, 0.01),
                                                 (0.3, 40, 1e-5, 0.999), (2.0, 1, 1e-5, 0.25)])
def test_subsampled_epsilon_equals_the_reference(sigma, steps, delta, q):
    got = tacc.gaussian_epsilon(sigma, steps, delta, sampling_rate=q)
    assert got == jacc.gaussian_epsilon(sigma, steps, delta, sampling_rate=q)
    assert got <= tacc.gaussian_epsilon(sigma, steps, delta)


@pytest.mark.parametrize("sigma,steps,delta", [(0.5, 10, 1e-5), (0.8, 6, 1e-5),
                                               (1.1, 100, 1e-6), (2.0, 40, 1e-5)])
def test_grid_within_one_percent_of_the_analytic_optimum(sigma, steps, delta):
    grid = tacc.gaussian_epsilon(sigma, steps, delta)
    ref = tacc.analytic_gaussian_epsilon(sigma, steps, delta)
    assert ref - 1e-9 <= grid <= ref * 1.01


def test_edge_cases():
    assert tacc.gaussian_epsilon(0.0, 10, 1e-5) == math.inf
    assert tacc.gaussian_epsilon(1.0, 0, 1e-5) == 0.0
    assert tacc.analytic_gaussian_epsilon(0.0, 10, 1e-5) == math.inf
    assert tacc.analytic_gaussian_epsilon(1.0, 0, 1e-5) == 0.0
    assert tacc.gaussian_epsilon(2.0, 10, 1e-5) < tacc.gaussian_epsilon(1.0, 10, 1e-5)
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            tacc.gaussian_epsilon(1.0, 10, bad)
    with pytest.raises(ValueError):
        tacc.rdp_gaussian(0.0, 10, tacc.DEFAULT_ORDERS)


def test_subsampled_bound_properties():
    """Never above the dense epsilon; monotone in q; the q = 1 bound is the
    dense RDP exactly; bad rates and fractional orders refused."""
    sigma, steps, delta = 0.8, 60, 1e-5
    dense = tacc.gaussian_epsilon(sigma, steps, delta)
    eps = [tacc.gaussian_epsilon(sigma, steps, delta, sampling_rate=q)
           for q in (0.01, 0.25, 0.9, 0.999)]
    assert all(0 < e <= dense + 1e-12 for e in eps)
    assert all(a <= b + 1e-9 for a, b in zip(eps, eps[1:]))
    orders = tacc.SUBSAMPLED_ORDERS
    np.testing.assert_array_equal(tacc.rdp_subsampled_gaussian(0.3, 0.9, 12, orders),
                                  jacc.rdp_subsampled_gaussian(0.3, 0.9, 12, orders))
    np.testing.assert_allclose(tacc.rdp_subsampled_gaussian(1.0, 0.9, 12, orders),
                               tacc.rdp_gaussian(0.9, 12, orders))
    with pytest.raises(ValueError):
        tacc.rdp_subsampled_gaussian(1.2, 0.9, 12, orders)
    with pytest.raises(ValueError):
        tacc.rdp_subsampled_gaussian(0.5, 0.9, 12, np.array([1.5, 2.5]))


@pytest.mark.parametrize("kw,frag", [(dict(clip=0.0, noise_multiplier=1.0), "clip"),
                                     (dict(clip=1.0, mode="per-batch"), "mode"),
                                     (dict(clip=1.0, noise_multiplier=-1.0), "multiplier")])
def test_dp_config_refuses_what_the_reference_refuses(kw, frag):
    with pytest.raises(ValueError, match=frag) as want:
        jdp.DPConfig(**kw)
    with pytest.raises(ValueError, match=frag) as got:
        tdp.DPConfig(**kw)
    assert str(got.value) == str(want.value)
    tdp.DPConfig(clip=1.0, noise_multiplier=0.0)       # clip-only is valid
