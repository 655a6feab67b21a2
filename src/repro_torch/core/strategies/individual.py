"""Baselines, ported from ``repro/core/strategies/individual.py``:
Individual (no exchange) and Pooled (a single-site federation over the
concatenated data).

Their hooks exchange nothing, so a round is each site's local steps.
Individual is also the local half that the compressed rounds and the
socket sites train under: the round loop does the exchange itself.
"""
from __future__ import annotations

from repro_torch.core.strategies.base import Strategy, register


@register
class Individual(Strategy):
    """Each site trains alone on its local data: the paper's lower baseline."""
    name = "individual"


@register
class Pooled(Strategy):
    """Centralized training on pooled data: the paper's upper baseline.

    A 1-site federation whose site sees every case: the round loop
    concatenates the sites' batches (``TaskBundle.pooled_view``)."""
    name = "pooled"
