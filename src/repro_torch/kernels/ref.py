"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the oracle that ``chip_smoke.py``
holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def fedagg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted site aggregation: out = sum_s w_s * x_s.  stacked: [S, N]."""
    return (weights.float()[:, None] * stacked.float()).sum(0).to(stacked.dtype)
