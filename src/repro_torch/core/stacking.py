"""Site-stacked parameter trees, ported from ``repro/core/stacking.py``.

Every federated quantity carries a leading ``S = num_sites`` axis.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def broadcast_to_sites(tree, num_sites: int):
    """An unstacked tree as [S, ...] views (no copy)."""
    return tree_map(lambda x: x[None].expand((num_sites,) + tuple(x.shape)), tree)


def where_site(mask: torch.Tensor, a, b):
    """Per-site select: mask [S] bool; a/b stacked trees."""
    def sel(x, y):
        m = mask.to(device=x.device, dtype=torch.bool)
        return torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return tree_map(sel, a, b)
