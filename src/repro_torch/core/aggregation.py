"""Weighted model aggregation (paper Eq. 1) with dropout masking, ported
from ``repro/core/aggregation.py``.

``fedavg_aggregate`` implements  w^{t+1} = sum_i (m_i / m) w_i^{t+1}
over the active sites; inactive sites keep their local weights (the
"disconnect" scenario).  ``hierarchical_aggregate`` aggregates within
each pod of ``sites_per_pod`` contiguous sites first, then across the
pods: the same weighted mean, since weighted means compose.

Both are thin wrappers over the shared
:class:`~repro_torch.core.agg_engine.AggregationEngine`, the port's one
implementation of Eq. 1 (the ``fedagg`` kernel on a card, its plain
version on the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.agg_engine import get_engine, normalized_weights  # noqa: F401


def fedavg_aggregate(params_stacked, case_weights: torch.Tensor, active=None):
    """Eq. 1 through the engine: (the new stacked params, the global
    model broadcast to the active sites; the global params)."""
    return get_engine().aggregate(params_stacked, case_weights, active)


def hierarchical_aggregate(params_stacked, case_weights: torch.Tensor, sites_per_pod: int,
                           active: Optional[torch.Tensor] = None):
    """Two-level FedAvg through the engine: per-pod partial means, then the
    cross-pod combine; equal to :func:`fedavg_aggregate` up to rounding."""
    return get_engine().aggregate_hierarchical(params_stacked, case_weights, sites_per_pod,
                                               active)
