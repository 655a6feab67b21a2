"""Algorithm 2: random site drop-in/drop-out, ported from ``repro/core/dropout.py``.

A bounded birth-death Markov chain on the number of *dropped* sites
``d in [0, N_max]``:

  * d == 0      : 1/2 chance one site drops out, 1/2 nothing
  * d == N_max  : 1/2 chance one site drops back in, 1/2 nothing
  * otherwise   : 1/3 drop out, 1/3 drop in, 1/3 nothing

Which site drops is uniform among active sites (which rejoins, among
dropped sites).  Host-side numpy, consuming the reference's random stream
draw for draw, so the same seed gives bit-equal masks.

:func:`availability_step_traced` is the reference's on-device twin of one
step, over JAX's threefry stream (:mod:`repro_torch.core.prng`): the same
law, another stream, bit for bit the reference's for the same key.

Scenarios (paper §III.C.2): ``disconnect`` (dropped sites train but do
not exchange) and ``shutdown`` (dropped sites neither train nor exchange).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng


class SiteAvailability:
    """Stateful Algorithm-2 chain producing per-round active masks."""

    def __init__(self, num_sites: int, max_dropout: int, seed: int = 0):
        if not 0 <= max_dropout < num_sites:
            raise ValueError(f"max_dropout must be in [0, {num_sites}), "
                             f"got {max_dropout}")
        self.num_sites = num_sites
        self.max_dropout = max_dropout
        self.rng = np.random.default_rng(seed)
        self.active = np.ones(num_sites, dtype=bool)

    @property
    def num_dropped(self) -> int:
        return int((~self.active).sum())

    def _drop_one(self):
        idx = self.rng.choice(np.flatnonzero(self.active))
        self.active[idx] = False

    def _rejoin_one(self):
        idx = self.rng.choice(np.flatnonzero(~self.active))
        self.active[idx] = True

    def step(self) -> np.ndarray:
        """Advance one FL round; returns the active mask for this round."""
        if self.max_dropout > 0:
            d = self.num_dropped
            u = self.rng.random()
            if d == 0:
                if u < 0.5:
                    self._drop_one()
            elif d == self.max_dropout:
                if u < 0.5:
                    self._rejoin_one()
            else:
                if u < 1 / 3:
                    self._drop_one()
                elif u < 2 / 3:
                    self._rejoin_one()
        return self.active.copy()


def availability_step_traced(key: torch.Tensor, active: torch.Tensor,
                             max_dropout: int) -> torch.Tensor:
    """One Algorithm-2 step on the device of ``key``: the previous round's
    [S] bool mask ``active`` -> this round's.  The key splits into (the
    step's uniform, the drop choice, the join choice); the site that drops
    (joins) is the argmax of uniforms over the active (dropped) sites, the
    first index winning a tie as in ``jnp.argmax``.  ``max_dropout == 0``
    returns ``active`` itself."""
    if max_dropout == 0:
        return active
    k_u, k_drop, k_join = prng.split(key, 3)
    n = active.shape[0]
    d = torch.sum(~active)
    u = prng.uniform(k_u, ())
    third = float(np.float32(1 / 3))
    p_drop = torch.where(d == 0, 0.5, torch.where(d >= max_dropout, 0.0, third))
    p_join = torch.where(d == 0, 0.0, torch.where(d >= max_dropout, 0.5, third))
    do_drop = u < p_drop
    do_join = (u >= p_drop) & (u < p_drop + p_join)
    drop_idx = torch.argmax(torch.where(active, prng.uniform(k_drop, (n,)), -1.0))
    join_idx = torch.argmax(torch.where(~active, prng.uniform(k_join, (n,)), -1.0))
    new = active.clone()
    new[drop_idx] = torch.where(do_drop, False, active[drop_idx])
    new[join_idx] = torch.where(do_join, True, new[join_idx])
    return new
