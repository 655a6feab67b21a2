"""Federation configuration, ported from ``repro/configs/base.py``.

Only the part the port's path reads: :class:`FederationConfig` (the
paper's FL hyper-parameters) and its Eq. 1 case weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FederationConfig:
    """Paper §II hyper-parameters.

    ``site_case_counts`` are the m_i of Eq. 1 (default: uniform);
    ``max_dropout_sites`` is N_max of Algorithm 2.
    """

    num_sites: int = 8
    strategy: str = "fedavg"
    local_steps: int = 1
    rounds: int = 100
    max_dropout_sites: int = 0
    dropout_scenario: str = "disconnect"   # disconnect | shutdown
    site_case_counts: Optional[Tuple[int, ...]] = None

    def case_weights(self) -> np.ndarray:
        if self.site_case_counts is None:
            w = np.ones((self.num_sites,), dtype=np.float32)
        else:
            if len(self.site_case_counts) != self.num_sites:
                raise ValueError(f"{len(self.site_case_counts)} case counts "
                                 f"for {self.num_sites} sites")
            w = np.asarray(self.site_case_counts, dtype=np.float32)
        return w / w.sum()
