"""Eq. 1 on one contiguous ``[S, N]`` buffer, ported from ``repro/core/agg_engine.py``.

Any parameter tree is raveled into a contiguous ``[S, N]`` fp32 buffer
(the ravel layout is cached per structure/shape/dtype key) and reduced
over the site axis by :func:`repro_torch.kernels.ops.fedagg`: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
Unlike the reference, nothing pads ``N``: the kernel masks its ragged
tail.

The round loop keeps every site's weights as the rows of such a
buffer, so :meth:`AggregationEngine.aggregate_round` reduces it in place
with no concatenate copy and broadcasts by writing the active rows.

Ported: the flat FedAvg path.  Pods, robust rules and the streaming
accumulator of the reference are not (the job rejects those seams).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stacking import broadcast_to_sites, where_site
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_EPS = 1e-12


def normalized_weights(case_weights: torch.Tensor, active,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """m_i/m over the active subset (fp32, ``+1e-12``); zero for inactive
    sites.  ``scale`` is an optional per-site factor multiplied in before
    the normalization."""
    w = case_weights.float() * torch.as_tensor(active, device=case_weights.device).float()
    if scale is not None:
        w = w * torch.as_tensor(scale, device=case_weights.device).float()
    return w / (torch.sum(w) + _EPS)


def per_site_nbytes(params_stacked) -> int:
    """Wire bytes of one site's uncompressed model (per-leaf dtypes)."""
    return sum(int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()
               for x in tree_leaves(params_stacked))


@dataclasses.dataclass(frozen=True)
class RavelLayout:
    """How a site-stacked tree maps into one contiguous [S, N] buffer."""
    treedef: Any                           # the tree's structure (any leaves)
    shapes: Tuple[Tuple[int, ...], ...]    # per-leaf shapes WITHOUT the site axis
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    n: int                                 # total flat param count

    def views(self, flat_row: torch.Tensor):
        """Per-leaf views (no copy) of one [N] row, in flatten order."""
        return [flat_row[ofs: ofs + int(np.prod(sh, dtype=np.int64))].view(sh)
                for sh, ofs in zip(self.shapes, self.offsets)]


class AggregationEngine:
    """Eq. 1 for every consumer: the FedAvg strategy and ``global_model``."""

    def __init__(self):
        self._layouts: Dict[Any, RavelLayout] = {}

    def reduce_flat(self, flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """One weighted reduction over the site axis: [S, N] x [S] -> [N]."""
        return ops.fedagg(flat, weights.float().contiguous())

    # -- ravel layout (cached per structure/shapes/dtypes) ------------------

    def layout_of(self, params_stacked) -> RavelLayout:
        leaves = tree_leaves(params_stacked)
        skeleton = tree_map(lambda _: None, params_stacked)
        key = (repr(skeleton), tuple(tuple(x.shape) for x in leaves),
               tuple(x.dtype for x in leaves))
        layout = self._layouts.get(key)
        if layout is None:
            shapes = tuple(tuple(x.shape[1:]) for x in leaves)
            sizes = [int(np.prod(sh, dtype=np.int64)) for sh in shapes]
            offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
            layout = RavelLayout(skeleton, shapes, tuple(x.dtype for x in leaves),
                                 offsets, sum(sizes))
            self._layouts[key] = layout
        return layout

    def flatten(self, params_stacked) -> Tuple[torch.Tensor, RavelLayout]:
        """Ravel a site-stacked tree into one [S, N] fp32 buffer."""
        layout = self.layout_of(params_stacked)
        leaves = tree_leaves(params_stacked)
        s = leaves[0].shape[0]
        flat = torch.cat([x.reshape(s, -1).float() for x in leaves], dim=1)
        return flat, layout

    def unflatten(self, flat_global: torch.Tensor, layout: RavelLayout):
        """[N] buffer -> unstacked tree, restoring per-leaf dtypes."""
        leaves = [v.to(dt) for v, dt in zip(layout.views(flat_global), layout.dtypes)]
        return tree_unflatten(layout.treedef, leaves)

    # -- Eq. 1 entry points -------------------------------------------------

    def global_mean(self, params_stacked, weights: torch.Tensor):
        """sum_s weights_s * params_s (weights already normalized) -> tree."""
        flat, layout = self.flatten(params_stacked)
        return self.unflatten(self.reduce_flat(flat, weights), layout)

    def aggregate(self, params_stacked, case_weights: torch.Tensor,
                  active=None, scale: Optional[torch.Tensor] = None):
        """Eq. 1 on a stacked tree.  Returns (new stacked params, global
        params): the global model broadcast to active sites; inactive
        sites keep their local weights (the "disconnect" scenario)."""
        s = tree_leaves(params_stacked)[0].shape[0]
        if active is None:
            active = np.ones((s,), bool)
        flat, layout = self.flatten(params_stacked)
        w = normalized_weights(case_weights, active, scale)
        global_params = self.unflatten(self.reduce_flat(flat, w), layout)
        mask = torch.as_tensor(np.asarray(active, bool))
        return (where_site(mask, broadcast_to_sites(global_params, s), params_stacked),
                global_params)

    def aggregate_flat(self, flat: torch.Tensor, case_weights: torch.Tensor,
                       active, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`aggregate` on the [S, N] buffer itself, in place: the
        active rows are overwritten with the global row, which is returned."""
        active = np.asarray(active, bool)
        gflat = self.reduce_flat(flat, normalized_weights(case_weights, active, scale))
        for i in np.flatnonzero(active):
            flat[i].copy_(gflat)
        return gflat

    def aggregate_round(self, flat: torch.Tensor, round_inputs, ctx):
        """Strategy ``post_exchange`` entry on the round loop's [S, N]
        buffer; returns (the buffer, updated in place, and the global row)."""
        gflat = self.aggregate_flat(flat, ctx.case_weights, round_inputs["active"],
                                    round_inputs.get("weight_scale"))
        return flat, gflat


_DEFAULT_ENGINE: Optional[AggregationEngine] = None


def get_engine() -> AggregationEngine:
    """Process-wide default engine (shared ravel-layout cache)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = AggregationEngine()
    return _DEFAULT_ENGINE
