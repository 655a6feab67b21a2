"""Rényi (moments) accountant for the Gaussian mechanism, ported from
``repro/privacy/accountant.py`` unchanged (pure math on ``math`` and numpy).

The DP-SGD noise added in :mod:`repro_torch.privacy.dp` is the Gaussian
mechanism on an L2-clipped gradient: sensitivity ``C`` (the clip norm),
noise ``N(0, (σ·C)²)`` per step.  Its Rényi divergence at order α is
the closed form (Mironov 2017, Prop. 7)

    RDP(α) = α / (2 σ²)

and RDP composes additively over the ``T = rounds × local_steps``
mechanism invocations each site performs, so the whole run costs
``T·α/(2σ²)`` at every order.  The (ε, δ) guarantee is the standard
RDP→DP conversion minimized over a grid of orders:

    ε(δ) = min_α  T·α/(2σ²) + log(1/δ)/(α − 1)

That minimum has an analytic optimum (∂/∂α = 0 at
``α* = 1 + sqrt(2σ²·log(1/δ)/T)``):

    ε* = T/(2σ²) + sqrt(2·T·log(1/δ))/σ

kept here as :func:`analytic_gaussian_epsilon` — the independent
reference the tests check the grid accountant against.

Poisson client sampling (``FederatedJob(sample="poisson:q")`` — each
site independently scheduled with probability q per round, the model
:mod:`repro_torch.core.sampling` implements) composes with per-site DP as the
*subsampled* Gaussian mechanism: a site's data only enters rounds the
sampler schedules it for, and privacy amplification by subsampling
tightens each invocation's RDP from ``α/(2σ²)`` to the
Mironov–Talwar–Zhang integer-order bound

    RDP_q(α) = 1/(α−1) · log Σ_{k=0}^{α} C(α,k) (1−q)^{α−k} q^k
                                         · e^{(k²−k)/(2σ²)}

(:func:`rdp_subsampled_gaussian`; at q = 1 only the k = α term
survives and the bound reduces to the dense ``α/(2σ²)`` exactly).
``gaussian_epsilon(..., sampling_rate=q)`` minimizes over integer
orders in that regime, and is never larger than the unsampled ε —
the property the reference's ``tests/test_privacy.py`` pins.  ``uniform:K`` sampling
is NOT Poisson (inclusions anti-correlate); the accountant
conservatively charges it at q = 1.

Without client sampling this accounts the *full-batch* Gaussian
mechanism (sampling rate q = 1 — every scheduled site uses its whole
round batch every step, there is no Poisson subsampling in the data
pipeline), which upper-bounds any subsampled variant.  ε is **per
site**: each site's data participates in at most T noisy steps
regardless of dropout schedule.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

#: Default RDP orders: dense near 1 (where the optimum lands for small
#: T/σ² budgets), then a geometric tail for very private runs.
DEFAULT_ORDERS = np.concatenate([
    np.linspace(1.01, 12.0, 441),
    np.linspace(12.5, 63.5, 103),
    np.array([128.0, 256.0, 512.0, 1024.0]),
])


def rdp_gaussian(noise_multiplier: float, steps: int,
                 orders: np.ndarray) -> np.ndarray:
    """RDP ε(α) of ``steps`` composed Gaussian mechanisms at σ=noise_multiplier."""
    if noise_multiplier <= 0:
        raise ValueError("RDP of the Gaussian mechanism needs σ > 0")
    orders = np.asarray(orders, np.float64)
    return steps * orders / (2.0 * noise_multiplier ** 2)


#: Integer RDP orders for the subsampled regime (the closed-form bound
#: above holds at integer α; fractional orders need the continued-
#: fraction machinery we deliberately avoid).
SUBSAMPLED_ORDERS = np.arange(2, 257)


def rdp_subsampled_gaussian(sampling_rate: float, noise_multiplier: float,
                            steps: int, orders: np.ndarray) -> np.ndarray:
    """RDP ε(α) of ``steps`` composed *Poisson-subsampled* Gaussian
    mechanisms at integer orders — the Mironov–Talwar–Zhang bound.

    Per invocation, with q = sampling_rate and σ = noise_multiplier:

        RDP_q(α) = 1/(α−1) · log Σ_{k=0}^{α} C(α,k) (1−q)^{α−k} q^k
                                             · e^{(k²−k)/(2σ²)}

    evaluated in log space (``lgamma`` binomials + logsumexp), so large
    orders and tiny rates stay finite.  q = 1 collapses to the dense
    ``α/(2σ²)`` exactly; q = 0 gives 0 (the site never participates).
    """
    if noise_multiplier <= 0:
        raise ValueError("RDP of the Gaussian mechanism needs σ > 0")
    if not 0.0 <= sampling_rate <= 1.0:
        raise ValueError(f"sampling_rate must be in [0, 1], got "
                         f"{sampling_rate}")
    orders = np.asarray(orders)
    if not np.all(orders == orders.astype(np.int64)) or np.any(orders < 2):
        raise ValueError("the subsampled bound needs integer orders >= 2")
    q, sigma = float(sampling_rate), float(noise_multiplier)
    if q == 1.0:
        return rdp_gaussian(sigma, steps, orders)
    out = np.empty(len(orders), np.float64)
    log_q = math.log(q) if q > 0 else -math.inf
    log_1mq = math.log1p(-q)
    for i, a in enumerate(orders.astype(np.int64)):
        terms = [math.lgamma(a + 1) - math.lgamma(k + 1)
                 - math.lgamma(a - k + 1)
                 + k * log_q + (a - k) * log_1mq
                 + (k * k - k) / (2.0 * sigma * sigma)
                 for k in range(a + 1)]
        m = max(terms)
        log_a = m + math.log(sum(math.exp(t - m) for t in terms))
        out[i] = steps * max(log_a, 0.0) / (a - 1)
    return out


def gaussian_epsilon(noise_multiplier: float, steps: int, delta: float,
                     orders: Optional[Sequence[float]] = None,
                     sampling_rate: float = 1.0) -> float:
    """(ε at the given δ) for ``steps`` Gaussian-mechanism invocations,
    via grid-minimized RDP→DP conversion.  Returns ``inf`` for σ = 0
    (no noise, no guarantee) and 0.0 for steps = 0.

    ``sampling_rate < 1`` switches to the Poisson-subsampled bound
    (:func:`rdp_subsampled_gaussian`) over the integer-order grid —
    privacy amplification from per-round client sampling."""
    if steps <= 0:
        return 0.0
    if noise_multiplier <= 0:
        return float("inf")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    dense = None
    if sampling_rate >= 1.0 or orders is None:
        alphas = np.asarray(DEFAULT_ORDERS if orders is None else orders,
                            np.float64)
        alphas = alphas[alphas > 1.0]
        eps = rdp_gaussian(noise_multiplier, steps, alphas) \
            + math.log(1.0 / delta) / (alphas - 1.0)
        dense = float(np.min(eps))
        if sampling_rate >= 1.0:
            return dense
    # subsampled regime: the closed-form amplification bound holds at
    # integer orders only, whose grid can miss the fractional-order
    # optimum near q = 1 — but the dense (q = 1) accounting always
    # upper-bounds the subsampled mechanism, so take the tighter of the
    # two valid bounds (this keeps ε monotone: sampled ≤ unsampled)
    alphas = np.asarray(SUBSAMPLED_ORDERS if orders is None else orders,
                        np.float64)
    alphas = alphas[alphas >= 2.0]
    eps = rdp_subsampled_gaussian(sampling_rate, noise_multiplier, steps,
                                  alphas) \
        + math.log(1.0 / delta) / (alphas - 1.0)
    sub = float(np.min(eps))
    return sub if dense is None else min(sub, dense)


def analytic_gaussian_epsilon(noise_multiplier: float, steps: int,
                              delta: float) -> float:
    """Closed-form optimum of the RDP→DP objective over continuous α —
    the analytic reference the grid accountant must match."""
    if steps <= 0:
        return 0.0
    if noise_multiplier <= 0:
        return float("inf")
    return (steps / (2.0 * noise_multiplier ** 2)
            + math.sqrt(2.0 * steps * math.log(1.0 / delta))
            / noise_multiplier)
