"""Per-round client sampling, ported from ``repro/core/sampling.py``.

A :class:`ClientSampler` decides which sites are *scheduled* each round,
independently of whether they are *available* (the Algorithm-2 dropout
chain).  The two compose by intersection:

    participate[r] = sampled[r] & available[r]

with one deterministic precedence rule: if the intersection of a round is
empty, the availability mask wins and every available site participates
at scale 1 that round (a sync barrier would otherwise deadlock and the
Eq. 1 weights would all be zero).

Sampler specs:

  * ``"none"``        -- every available site, every round (cross-silo).
  * ``"uniform:K"``   -- K sites uniformly without replacement per round
                         (inclusion probability pi = K/S).
  * ``"poisson:q"``   -- each site independently with probability q per
                         round (pi = q).

Each round's mask is a pure function of (seed, round): a fresh
``np.random.default_rng((seed + SAMPLER_SEED_OFFSET, r))`` per round,
drawn exactly as the reference draws it, so masks are bit-equal.

Eq. 1 reweighting: each participant's case weight is multiplied by the
float32 Horvitz-Thompson factor ``1/pi`` and the weights are then
self-normalized (the Hajek estimator); :func:`compose_participation`
returns that per-round ``[S]`` scale (``1/pi`` on sampled rounds, ``1.0``
on fallback rounds).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np

# the sampler's own stream, disjoint from the Algorithm-2 site chain (seed)
SAMPLER_SEED_OFFSET = 7919


@dataclass(frozen=True)
class ClientSampler:
    """Which sites are scheduled each round.  ``kind`` in {none, uniform,
    poisson}; ``count`` is uniform's K, ``rate`` is poisson's q."""

    kind: str = "none"
    count: int = 0          # uniform:K
    rate: float = 0.0       # poisson:q

    @property
    def spec(self) -> str:
        """The canonical string form (what ``sample=`` parses)."""
        if self.kind == "uniform":
            return f"uniform:{self.count}"
        if self.kind == "poisson":
            return f"poisson:{self.rate:g}"
        return "none"

    def is_trivial(self, num_sites: int) -> bool:
        """True when every site is scheduled every round: ``none``,
        ``uniform:K`` with K >= S, ``poisson:q`` with q >= 1.  Trivial
        samplers take the dense path verbatim."""
        if self.kind == "none":
            return True
        if self.kind == "uniform":
            return self.count >= num_sites
        return self.rate >= 1.0

    def inclusion_probability(self, num_sites: int) -> float:
        """pi, every site's per-round inclusion probability."""
        if self.is_trivial(num_sites):
            return 1.0
        if self.kind == "uniform":
            return self.count / num_sites
        return self.rate

    def round_mask(self, num_sites: int, seed: int, round_index: int) -> np.ndarray:
        """[S] bool scheduled mask for one round, a pure function of
        (seed, round)."""
        if self.is_trivial(num_sites):
            return np.ones((num_sites,), bool)
        rng = np.random.default_rng((seed + SAMPLER_SEED_OFFSET, round_index))
        mask = np.zeros((num_sites,), bool)
        if self.kind == "uniform":
            mask[rng.permutation(num_sites)[:self.count]] = True
        else:
            mask = rng.random(num_sites) < self.rate
        return mask

    def masks(self, num_sites: int, seed: int, rounds: int) -> np.ndarray:
        """[rounds, S] scheduled masks (stacked :meth:`round_mask`)."""
        return np.stack([self.round_mask(num_sites, seed, r) for r in range(rounds)])


NONE_SAMPLER = ClientSampler()


def resolve_sampler(spec: Union[str, ClientSampler, None]) -> ClientSampler:
    """``"none" | "uniform:K" | "poisson:q"`` (or a ClientSampler) ->
    :class:`ClientSampler`."""
    if spec is None:
        return NONE_SAMPLER
    if isinstance(spec, ClientSampler):
        return spec
    if spec == "none":
        return NONE_SAMPLER
    if spec.startswith("uniform:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad sampler spec {spec!r}: uniform:K needs "
                             "an integer K")
        if k < 1:
            raise ValueError(f"uniform:K needs K >= 1, got {k}")
        return ClientSampler(kind="uniform", count=k)
    if spec.startswith("poisson:"):
        try:
            q = float(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad sampler spec {spec!r}: poisson:q needs "
                             "a float q")
        if not 0.0 < q:
            raise ValueError(f"poisson:q needs q > 0, got {q}")
        return ClientSampler(kind="poisson", rate=q)
    raise ValueError(f"unknown sampler spec {spec!r}; known: none, "
                     "uniform:K, poisson:q")


def compose_participation(sampler: ClientSampler, available: np.ndarray,
                          seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect the sampler's schedule with the [rounds, S] Algorithm-2
    availability masks.  Returns ``(participate, scale)``:

      * ``participate`` [rounds, S] bool: sampled & available, except on
        rounds where that is empty, where the availability mask wins;
      * ``scale`` [rounds, S] float32: ``1/pi`` on participating rows
        (``1.0`` on fallback rounds and for trivial samplers), zero
        elsewhere.
    """
    available = np.asarray(available, bool)
    rounds, num_sites = available.shape
    if sampler.is_trivial(num_sites):
        return available, available.astype(np.float32)
    sampled = sampler.masks(num_sites, seed, rounds)
    participate = sampled & available
    inv_pi = np.float32(1.0 / sampler.inclusion_probability(num_sites))
    scale = participate.astype(np.float32) * inv_pi
    empty = ~participate.any(axis=1)
    participate[empty] = available[empty]
    scale[empty] = available[empty].astype(np.float32)
    return participate, scale
