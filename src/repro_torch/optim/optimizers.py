"""Functional optimizers, ported from ``repro/optim/optimizers.py``.

Pure functions over parameter trees (nested dicts/lists of tensors, or a
single tensor), in the reference's ``(init, update)`` form rather than
``torch.optim``: the round loop keeps every site's moments as rows of
one ``[S, N]`` buffer and hands one row at a time to ``update``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params) -> (updates, state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with bias correction and fp32 moments; decay applies to every
    leaf.

    The step count is cast to fp32 for the bias corrections, and the
    update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, as in the
    reference."""

    def init(params):
        leaves = tree_leaves(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m + (1 - b1) * g32
            v32 = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m32 / c1
            vhat = v32 / c2
            u = -(lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()))
            return u, m32, v32

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), tree_leaves(params))]
        updates = tree_unflatten(grads, [o[0] for o in out])
        mu = tree_unflatten(grads, [o[1] for o in out])
        nu = tree_unflatten(grads, [o[2] for o in out])
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)
