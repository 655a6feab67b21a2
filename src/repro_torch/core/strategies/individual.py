"""Individual training (no exchange), ported from ``repro/core/strategies/individual.py``.

The paper's lower baseline, and the local half that the compressed
round trains under: its hooks exchange nothing, so the round is each
site's local steps, and the compressed driver does the exchange itself.
"""
from __future__ import annotations

from repro_torch.core.strategies.base import Strategy, register


@register
class Individual(Strategy):
    """Each site trains alone on its local data."""
    name = "individual"
