"""Parameters between the JAX reference's layout and the port's.

The reference stores SA-Net's conv weights DHWIO (``[kd, kh, kw, in,
out]``); the port stores them OIDHW (``[out, in, kd, kh, kw]``), the
layout ``F.conv3d`` takes.  Every other leaf (biases, GroupNorm scales,
SE matrices ``[in, out]``) has the same orientation in both.  The tree
nesting is the same in both, so a conversion is a map over the leaves.
A token model's tree has no 5-D leaf (dense weights are ``[d_in, d_out]``
in both packages, stacked layers add one leading axis, MoE experts one
more), so it crosses unchanged.

The functions take and return plain numpy/tensor trees; nothing here
imports JAX (pass ``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)
_OIDHW_TO_DHWIO = (2, 3, 4, 1, 0)


def reference_order(shape):
    """The axis order that views a port leaf of ``shape`` in the
    reference's element order (``None`` when both orders agree)."""
    return _OIDHW_TO_DHWIO if len(shape) == 5 else None


def from_reference(params):
    """A reference parameter tree (numpy leaves) -> the port's CPU tensors."""
    def leaf(x):
        a = np.asarray(x)
        if a.ndim == 5:
            a = a.transpose(_DHWIO_TO_OIDHW)
        return torch.tensor(np.ascontiguousarray(a))
    return tree_map(leaf, params)


def to_reference(params):
    """The port's parameter tree -> numpy leaves in the reference layout."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(_OIDHW_TO_DHWIO)) if a.ndim == 5 else a
    return tree_map(leaf, params)
