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

:func:`pair_sites_traced` is the reference's on-device twin: the same
law over JAX's threefry stream (:mod:`repro_torch.core.prng`), bit for bit
the reference's pairs for the same key.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng


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


def pair_sites_traced(key: torch.Tensor, active: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pair_sites`'s law on the device of ``key``: the active sites
    in a random order (a stable sort of uniforms, +2 on the inactive
    sites' so they sort last), paired off consecutively, an odd one out
    sitting the exchange out.  A pair is real when both of its sites are
    active; the others are masked out.  Returns ``(partner, is_receiver,
    is_sender)`` tensors."""
    n = active.shape[0]
    dev = key.device
    noise = prng.uniform(key, (n,))
    order = torch.argsort(torch.where(active, noise, noise + 2.0), stable=True)
    pairs = n // 2                   # an odd site out joins neither role
    senders, receivers = order[0:2 * pairs:2], order[1::2]
    valid = (2 * torch.arange(pairs, device=dev) + 1) < torch.sum(active)
    partner = torch.arange(n, device=dev)
    partner[receivers[valid]] = senders[valid]
    is_recv = torch.zeros(n, dtype=torch.bool, device=dev)
    is_recv[receivers[valid]] = True
    is_send = torch.zeros(n, dtype=torch.bool, device=dev)
    is_send[senders[valid]] = True
    return partner, is_recv, is_send
