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


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda _: lr)


def _zeros_like(p, dtype) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def sgd(lr, momentum: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """SGD with optional (heavy-ball) momentum kept in ``state_dtype``;
    ``lr`` a float or a schedule ``lr(step)`` of the step count (an int32
    tensor, 1 at the first update)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        state = {"step": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}
        if momentum:
            state["mom"] = tree_map(lambda p: _zeros_like(p, state_dtype), params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = tree_map(lambda m, g: (momentum * m.float() + g.float()).to(state_dtype),
                           state["mom"], grads)
            return tree_map(lambda m: -lr_t * m.float(), mom), {"step": step, "mom": mom}
        return tree_map(lambda g: -lr_t * g.float(), grads), {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """AdamW with bias correction; decay applies to every leaf.

    ``lr`` is a float or a schedule ``lr(step)`` of the step count (an
    int32 tensor, 1 at the first update).  The moments are stored in
    ``state_dtype`` and updated in fp32, then cast back.  The step count
    is cast to fp32 for the bias corrections, and the update is ``-lr *
    (m_hat / (sqrt(v_hat) + eps) + wd * p)``, as in the reference."""
    lr_fn = _lr_fn(lr)

    def init(params):
        leaves = tree_leaves(params)
        return {"step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                "mu": tree_map(lambda p: _zeros_like(p, state_dtype), params),
                "nu": tree_map(lambda p: _zeros_like(p, state_dtype), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            mhat = m32 / c1
            vhat = v32 / c2
            u = -(lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()))
            return u, m32.to(state_dtype), v32.to(state_dtype)

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), tree_leaves(params))]
        updates = tree_unflatten(grads, [o[0] for o in out])
        mu = tree_unflatten(grads, [o[1] for o in out])
        nu = tree_unflatten(grads, [o[2] for o in out])
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)
