"""GCML, Gossip Contrastive Mutual Learning (paper Eq. 3, Algorithm 1),
ported from ``repro/core/strategies/gcml.py``.

Fully decentralized: no aggregation server.  Each round the coordinator
pairs active sites into (sender, receiver); the receiver pulls the
sender's weights, runs regional DCML (both the local and the incoming
model take one mutual-distillation SGD step on the receiver's local
batch) and merges them weighted by their validation losses.  Local
training then proceeds as usual.

The reference vmaps every site over the round's entry parameters.  The
port runs the receivers one after another on rows of the ``[S, N]``
buffer, so every incoming model is read from a copy of the buffer as it
entered the round (:func:`~repro_torch.core.stacking.gather_sites`, taken
before the first merge is written; a receiver's own row is written by its
own step only).  Only rows with ``is_receiver & active`` are replaced;
other sites run no DCML step (the reference computes one for them and
discards it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agg_engine import unravel
from repro_torch.core.dcml import dcml_losses, merge_by_validation
from repro_torch.core.stacking import gather_sites
from repro_torch.core.strategies.base import Strategy, register


def make_site_dcml(ctx):
    """Per-site regional DCML step (Eq. 3): mutual-distillation SGD on
    (receiver, incoming sender) models, merged by validation loss.

    The returned fn maps ``(p_r, p_s, batch, val_batch, layout)`` (two flat
    ``[N]`` rows, one site's batches, the rows' ravel layout) to
    ``(merged_row, (l_r, l_s, v_r, v_s))``.  The step is plain SGD at
    ``ctx.dcml_lr`` on ``l_r + l_s`` for both models (the teacher's logits
    are detached in each term, so each model's gradient is its own
    objective's), then each model's validation loss, then the merge.  Each
    model runs one forward for its base loss and its logits
    (:func:`~repro_torch.core.dcml.dcml_losses` on ``ctx.forward_fn``).

    With ``aggregator="normclip:c"`` the incoming model's delta against
    the receiver is L2-clipped to ``c`` before DCML: a Byzantine push can
    steer a receiver by at most ``c`` per round.
    """
    lam = ctx.fed.gcml_lambda
    beta = ctx.fed.gcml_contrast_beta
    eta = ctx.dcml_lr
    clip_c = ctx.aggregator.c if ctx.aggregator.name == "normclip" else 0.0

    def site_dcml(p_r, p_s, b, vb, layout):
        p_r, p_s = p_r.float(), p_s.float()
        if clip_c:
            delta = p_s - p_r
            nrm = torch.sqrt(torch.sum(delta * delta))
            fac = torch.clamp(clip_c / torch.clamp_min(nrm, 1e-12), max=1.0)
            p_s = p_r + fac * delta
        tree_r, leaves_r = layout.trainable(p_r)
        tree_s, leaves_s = layout.trainable(p_s)
        l_r, l_s = dcml_losses(ctx.forward_fn, tree_r, tree_s, b, lam, beta)
        grads = torch.autograd.grad(l_r + l_s, leaves_r + leaves_s, allow_unused=True)
        n = len(leaves_r)
        w_r = p_r - eta * layout.flat_grad(leaves_r, grads[:n])
        w_s = p_s - eta * layout.flat_grad(leaves_s, grads[n:])
        with torch.no_grad():
            v_r = ctx.scalar_loss_fn(unravel(w_r, layout), vb)
            v_s = ctx.scalar_loss_fn(unravel(w_s, layout), vb)
        merged = merge_by_validation(w_r, w_s, v_r, v_s)
        return merged, (l_r.detach(), l_s.detach(), v_r, v_s)

    return site_dcml


@register
class GCML(Strategy):
    name = "gcml"
    needs_pairing = True
    needs_val_batch = True

    def pre_exchange(self, fl_state, round_inputs, ctx):
        flat, layout = fl_state["params"], fl_state["layout"]
        take = np.asarray(round_inputs["is_receiver"], bool) & np.asarray(
            round_inputs["active"], bool)
        receivers = np.flatnonzero(take)
        # every incoming model from the round's entry buffer, copied before
        # the first merge is written (a sender may also receive)
        incoming = gather_sites(flat, np.asarray(round_inputs["partner"])[receivers])
        batch, val_batch = round_inputs["dcml_batch"], round_inputs["val_batch"]
        site_dcml = make_site_dcml(ctx)
        nan = torch.full((flat.shape[0],), float("nan"), device=flat.device)
        metrics = {k: nan.clone() for k in
                   ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s")}
        for i, p_s in zip(receivers, incoming):
            # fresh buffers: cuDNN picks its algorithms by the weights'
            # alignment (see the local phase)
            merged, out = site_dcml(flat[i].clone(), p_s.clone(),
                                    {k: v[i] for k, v in batch.items()},
                                    {k: v[i] for k, v in val_batch.items()}, layout)
            flat[i].copy_(merged)      # row i is read by its own step only
            for acc, v in zip(metrics.values(), out):
                acc[i] = v
        return {**fl_state, "params": flat,
                "metrics": {**fl_state.get("metrics", {}), **metrics}}
