"""FedProx (Li et al. 2018), paper Eq. 2, ported from ``repro/core/strategies/fedprox.py``.

FedAvg aggregation plus a proximal term ``(mu/2) ||w_i - w^t||^2`` on each
site's local objective, anchoring local models to the last global model
under data heterogeneity.  The anchor is a flat ``[N]`` global on the
job's device: the round-0 anchor is the mean of the sites' identical
initial rows (one ``fedagg`` launch), and each round's aggregation
re-anchors to the global it produces.
"""
from __future__ import annotations

import torch

from repro_torch.core.agg_engine import get_engine
from repro_torch.core.strategies.base import Strategy, register
from repro_torch.tree import tree_leaves


def prox_term(params_site, global_params, mu: float) -> torch.Tensor:
    """``(mu/2) * sum over leaves of ||p - g||^2`` for two trees alike."""
    sq = sum(torch.sum(torch.square(p.float() - g.float()))
             for p, g in zip(tree_leaves(params_site), tree_leaves(global_params)))
    return 0.5 * mu * sq


@register
class FedProx(Strategy):
    name = "fedprox"

    def init_state(self, params_flat, ctx):
        # the round-0 global model is the shared initialization
        s = params_flat.shape[0]
        w = torch.ones((s,), dtype=torch.float32, device=params_flat.device) / s
        return {"global": get_engine().reduce_flat(params_flat, w)}

    def local_loss_extra(self, params_site, strat_state, ctx):
        # the flat anchor, viewed leaf by leaf like the site's tree
        leaves = tree_leaves(params_site)
        anchor = torch.split(strat_state["global"], [p.numel() for p in leaves])
        return prox_term(leaves, [g.view(p.shape) for g, p in zip(anchor, leaves)],
                         ctx.fed.prox_mu)

    def post_exchange(self, fl_state, round_inputs, ctx):
        params, global_row = get_engine().aggregate_round(
            fl_state["params"], round_inputs, ctx)
        return {**fl_state, "params": params, "strategy": {"global": global_row}}


@register
class FedProxLocal(FedProx):
    """FedProx's *site half* only: the Eq. 2 proximal pull toward the
    anchored global, with no in-round aggregation.  The compressed rounds
    train under it and re-anchor ``strategy["global"]`` to each broadcast
    global, as a FedProx client does between exchanges."""

    name = "fedprox-local"

    def post_exchange(self, fl_state, round_inputs, ctx):
        return fl_state
