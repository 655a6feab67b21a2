"""The federated round, ported from ``repro/core/federation.py``.

One FL round (Figs 3/4, Algorithm 1):

  1. local training: ``local_steps`` optimizer steps per site, each site
     on its own batch shard;
  2. post-exchange: weighted aggregation + broadcast (Eq. 1);
  3. dropout semantics: "shutdown" sites skip (1); inactive sites always
     skip (2) (their aggregation weight is zero and they keep their local
     weights).

The reference vmaps the site axis.  The port runs the sites one after
another, which is the same math with one site's activations at a time
(a full-width SA-Net step at 128^3 holds several GB of them).  Every
site's weights are a row of one ``[S, N]`` fp32 buffer, and so are
AdamW's moments: a site step differentiates with respect to per-leaf
views of its row, clips and updates the flat row, and the aggregation
kernel then reads the buffer itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import FederationConfig
from repro_torch.core.agg_engine import get_engine
from repro_torch.core.stacking import broadcast_to_sites
from repro_torch.core.strategies import base as strat_base
# strategy modules self-register on import
from repro_torch.core.strategies import fedavg as _f  # noqa: F401
from repro_torch.core.strategies import individual as _i  # noqa: F401
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_unflatten


@dataclasses.dataclass
class FLContext:
    """What the round loop and strategy hooks read."""
    fed: FederationConfig
    case_weights: torch.Tensor         # [S] fp32 on ``device``
    loss_fn: Callable                  # (params, batch) -> (loss, metrics)
    optimizer: Optimizer
    grad_clip: float
    device: torch.device


def init_fl_state(ctx: FLContext, params) -> Dict:
    """Round-0 federated state: ``params`` (one unstacked tree) on every
    site (the paper's same-init FedAvg), as rows of an [S, N] buffer."""
    s = ctx.fed.num_sites
    flat, layout = get_engine().flatten(broadcast_to_sites(params, s))
    if any(dt != torch.float32 for dt in layout.dtypes):
        raise TypeError("the round loop trains fp32 parameters; got "
                        f"{sorted({str(d) for d in layout.dtypes})}")
    flat = flat.to(ctx.device).contiguous()
    opt = ctx.optimizer.init(flat)
    opt["step"] = torch.zeros((s,), dtype=torch.int32, device=ctx.device)
    strategy = strat_base.get_strategy(ctx.fed.strategy)
    return {"params": flat, "layout": layout, "opt": opt,
            "strategy": strategy.init_state(flat, ctx), "round": 0}


def make_round_inputs(ctx: FLContext, active: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side coordinator outputs for one round: the [S] active mask
    (from the job's precomputed Algorithm-2 schedule)."""
    if len(active) != ctx.fed.num_sites:
        raise ValueError(f"{len(active)} mask entries for {ctx.fed.num_sites} sites")
    return {"active": np.asarray(active, bool)}


def build_fl_round(ctx: FLContext):
    """Returns ``fl_round(fl_state, batches, round_inputs) -> (fl_state, metrics)``.

    ``batches`` leaves are [S, local_steps, per-site batch...] tensors on
    ``ctx.device``; ``metrics["loss"]`` is each site's loss at its last
    local step, [S].
    """
    strategy = strat_base.get_strategy(ctx.fed.strategy)

    def site_train_step(row, opt, batch, layout, strat_ref):
        leaves = [v.detach().requires_grad_() for v in layout.views(row)]
        params = tree_unflatten(layout.treedef, leaves)
        loss, metrics = ctx.loss_fn(params, batch)
        loss = loss + strategy.local_loss_extra(params, strat_ref, ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1)
                       for p, gr in zip(leaves, grads)])
        if ctx.grad_clip:
            g, gnorm = clip_by_global_norm(g, ctx.grad_clip)
        else:
            gnorm = torch.zeros((), device=row.device)
        updates, opt = ctx.optimizer.update(g, opt, row)
        row = apply_updates(row, updates)
        return row, opt, {"loss": loss.detach(), "grad_norm": gnorm, **metrics}

    def local_phase(fl_state, batches, active):
        flat, layout, opt = fl_state["params"], fl_state["layout"], fl_state["opt"]
        shutdown = ctx.fed.dropout_scenario == "shutdown"
        losses = []
        for s in range(flat.shape[0]):
            row = flat[s]
            site_opt = {"step": opt["step"][s], "mu": opt["mu"][s], "nu": opt["nu"][s]}
            for k in range(next(iter(batches.values())).shape[1]):
                batch = {name: b[s, k] for name, b in batches.items()}
                row, site_opt, m = site_train_step(row, site_opt, batch, layout,
                                                   fl_state["strategy"])
            losses.append(m["loss"])
            if shutdown and not active[s]:
                continue        # workstation off: the site's state is untouched
            flat[s].copy_(row)
            opt["mu"][s].copy_(site_opt["mu"])
            opt["nu"][s].copy_(site_opt["nu"])
            opt["step"][s] = site_opt["step"]
        return fl_state, {"loss": torch.stack(losses)}

    def fl_round(fl_state, batches, round_inputs):
        active = np.asarray(round_inputs["active"], bool)
        ri = {**round_inputs, "active": active}
        fl_state = strategy.pre_exchange(fl_state, ri, ctx)
        fl_state, metrics = local_phase(fl_state, batches, active)
        fl_state = strategy.post_exchange(fl_state, ri, ctx)
        fl_state = {**fl_state, "round": fl_state["round"] + 1}
        return fl_state, metrics

    return fl_round


def global_model(fl_state, ctx: FLContext):
    """Case-weighted global model from the current stacked params (what
    gets served as 'the' model)."""
    eng = get_engine()
    w = ctx.case_weights / torch.sum(ctx.case_weights)
    return eng.unflatten(eng.reduce_flat(fl_state["params"], w), fl_state["layout"])
