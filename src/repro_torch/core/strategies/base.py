"""Strategy interface, ported from ``repro/core/strategies/base.py``.

A strategy contributes hooks to the federated round (Fig 3/4):

  * ``init_state``       -- per-federation state (FedProx's global model)
  * ``pre_exchange``     -- model exchange BEFORE local training
                            (decentralized FL: receive + DCML, Algorithm 1)
  * ``post_exchange``    -- aggregation AFTER local training (Eq. 1/2)
  * ``local_loss_extra`` -- an additive term on the local objective
                            (FedProx's proximal term, Eq. 2)

In the port the stacked parameters are the round loop's ``[S, N]``
buffer; host-side coordination arrives through ``round_inputs``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


class Strategy:
    name: str = "base"
    needs_pairing: bool = False         # round inputs carry a gossip pairing
    needs_val_batch: bool = False       # round inputs carry DCML/validation batches

    def init_state(self, params_flat, ctx) -> Dict[str, Any]:
        return {}

    def local_loss_extra(self, params_site, strat_state, ctx) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=ctx.device)

    def pre_exchange(self, fl_state, round_inputs, ctx):
        return fl_state

    def post_exchange(self, fl_state, round_inputs, ctx):
        return fl_state


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def get_strategy(name: str) -> Strategy:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown FL strategy {name!r}; known: {sorted(_REGISTRY)}")
