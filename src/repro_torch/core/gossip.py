"""Gossip pairing, ported from ``repro/core/gossip.py``: the decentralized
coordinator's role assignment.

Each FL round the coordination server (Fig 4 / Algorithm 1) selects
Sender/Receiver pairs among *active* sites.  The host computes the
pairing with numpy, line for line as the reference does, so one seed
gives the same pairs; the exchange consumes three arrays:

  * ``partner[i]``   -- index whose model site ``i`` pulls (identity when
                        not a receiver)
  * ``is_receiver``  -- bool mask of receiver sites
  * ``is_sender``    -- bool mask of sender sites

The reference's ``pair_sites_traced`` draws from JAX's PRNG inside its
compiled round engine and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pair_sites(active: np.ndarray, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random sender->receiver pairing among active sites.

    Active sites are shuffled and split into (sender, receiver) pairs;
    an odd site out participates as neither (it only does local training
    this round, as in the paper's implementation).
    """
    n = active.shape[0]
    partner = np.arange(n)
    is_recv = np.zeros(n, bool)
    is_send = np.zeros(n, bool)
    idx = np.flatnonzero(active)
    rng.shuffle(idx)
    for a, b in zip(idx[0::2], idx[1::2]):
        # a sends to b: receiver b pulls a's model
        partner[b] = a
        is_send[a] = True
        is_recv[b] = True
    return partner, is_recv, is_send


def ring_pairs(active: np.ndarray, round_index: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic ring gossip (every active site both sends and
    receives from its clockwise active neighbour): the lower-variance
    alternative schedule."""
    n = active.shape[0]
    partner = np.arange(n)
    idx = np.flatnonzero(active)
    k = len(idx)
    is_recv = np.zeros(n, bool)
    is_send = np.zeros(n, bool)
    if k >= 2:
        shift = 1 + (round_index % max(k - 1, 1))
        for j, i in enumerate(idx):
            partner[i] = idx[(j + shift) % k]
            is_recv[i] = True
            is_send[i] = True
    return partner, is_recv, is_send


def pair_sites_traced(key, active):
    """The reference's on-device pairing draws from JAX's PRNG inside its
    compiled round engine; the port pairs on the host (:func:`pair_sites`)."""
    from repro_torch import NotPorted
    raise NotPorted("pair_sites_traced", "a traced pairing", "pair_sites on the host")
