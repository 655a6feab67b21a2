"""Site-stacked parameter trees, ported from ``repro/core/stacking.py``.

Every federated quantity carries a leading ``S = num_sites`` axis; the
round loop keeps the sites' weights as the rows of one ``[S, N]`` buffer,
so the site-axis operations here are row operations on it.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map, tree_unflatten


def broadcast_to_sites(tree, num_sites: int):
    """An unstacked tree as [S, ...] views (no copy)."""
    return tree_map(lambda x: x[None].expand((num_sites,) + tuple(x.shape)), tree)


def where_site(mask: torch.Tensor, a, b):
    """Per-site select: mask [S] bool; a/b stacked trees."""
    def sel(x, y):
        m = mask.to(device=x.device, dtype=torch.bool)
        return torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return tree_map(sel, a, b)


def site_slice(flat: torch.Tensor, i: int, layout):
    """Site ``i``'s parameter tree: per-leaf views of row ``i`` of the
    ``[S, N]`` buffer that the ravel ``layout`` describes."""
    return tree_unflatten(layout.treedef, layout.views(flat[i]))


def gather_sites(flat: torch.Tensor, indices) -> torch.Tensor:
    """Permute the site axis of an ``[S, N]`` buffer (the gossip exchange):
    ``out[i] = flat[indices[i]]``, a new buffer."""
    idx = torch.as_tensor(indices, device=flat.device, dtype=torch.long)
    return flat.index_select(0, idx)
