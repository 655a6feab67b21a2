"""The federated round, ported from ``repro/core/federation.py``.

One FL round (Figs 3/4, Algorithm 1):

  1. (decentralized) pre-exchange: receive a peer's model + regional
     DCML (GCML);
  2. local training: ``local_steps`` optimizer steps per site, each site
     on its own batch shard, with the strategy's extra local term
     (FedProx's proximal pull);
  3. (centralized) post-exchange: weighted aggregation + broadcast (Eq. 1);
  4. dropout semantics: "shutdown" sites skip (2); inactive sites always
     skip the exchanges (their aggregation weight is zero and they keep
     their local weights).

Host-side per-round inputs (the active mask, the gossip pairing) come
from the job's precomputed schedule and :mod:`repro_torch.core.gossip`;
under ``device_data`` they are drawn on the device from JAX's threefry
stream (:func:`make_round_inputs_traced`).

A Byzantine adversary plan (``FLContext.adversary``) injects its faults
where the reference does: label flips on the round's batches before
``pre_exchange``, parameter perturbations on the rows of malicious active
sites after local training and before ``post_exchange`` (the ``noise``
attack keyed off the carried round counter).

DP-SGD (``FLContext.privacy``, a :class:`~repro_torch.privacy.dp.DPConfig`)
replaces ``grad_clip`` in every site step: clipping and Gaussian noise
keyed by ``(seed, fl_state["round"], dp_site_base + site, step)``, so the
stream replays across engines, transports and a resume.

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
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FederationConfig
from repro_torch.core.adversary import AdversaryPlan
from repro_torch.core.agg_engine import FEDAVG_SPEC, AggregatorSpec, get_engine
from repro_torch.core.stacking import broadcast_to_sites
from repro_torch.core.strategies import base as strat_base
from repro_torch.core.topology import FLAT, Topology
# strategy modules self-register on import
from repro_torch.core.strategies import fedavg as _f  # noqa: F401
from repro_torch.core.strategies import fedprox as _p  # noqa: F401
from repro_torch.core.strategies import gcml as _g  # noqa: F401
from repro_torch.core.strategies import individual as _i  # noqa: F401
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.privacy.dp import dp_gradients, round_key, site_step_key


@dataclasses.dataclass
class FLContext:
    """What the round loop and strategy hooks read."""
    fed: FederationConfig
    case_weights: torch.Tensor         # [S] fp32 on ``device``
    loss_fn: Callable                  # (params, batch) -> (loss, metrics)
    optimizer: Optimizer
    grad_clip: float
    device: torch.device
    aggregator: AggregatorSpec = FEDAVG_SPEC   # the site->global combine rule
    adversary: Optional[AdversaryPlan] = None  # in-round fault injection
    # (params, batch) -> (loss, logits, labels) from ONE forward: GCML's
    # DCML step reads both from it rather than running the network twice
    forward_fn: Optional[Callable] = None
    dcml_lr: Optional[float] = None            # GCML's DCML SGD step size
    topology: Topology = FLAT                  # flat, or two tiers of pods
    # DP-SGD (a repro_torch.privacy.DPConfig) or None; dp_site_base maps
    # this view's site rows to global site ids (a socket site's row 0 is
    # its own id), so every transport draws the same noise
    privacy: Optional[Any] = None
    dp_site_base: int = 0

    def scalar_loss_fn(self, params, batch):
        return self.loss_fn(params, batch)[0]

    def logits_fn(self, params, batch):
        return self.forward_fn(params, batch)[1:]


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


def make_round_inputs(ctx: FLContext, active: np.ndarray,
                      rng: Optional[np.random.Generator] = None,
                      round_index: int = 0) -> Dict[str, np.ndarray]:
    """Host-side coordinator outputs for one round: the [S] active mask
    (from the job's precomputed schedule) and, for a pairing strategy,
    the gossip pairing drawn from ``rng`` (default: a generator seeded by
    ``round_index``); without one, ``partner`` is the identity and no
    site receives."""
    from repro_torch.core.gossip import pair_sites
    s = ctx.fed.num_sites
    if len(active) != s:
        raise ValueError(f"{len(active)} mask entries for {s} sites")
    active = np.asarray(active, bool)
    partner = np.arange(s)
    is_recv = np.zeros(s, bool)
    if strat_base.get_strategy(ctx.fed.strategy).needs_pairing:
        rng = rng or np.random.default_rng(round_index)
        partner, is_recv, _ = pair_sites(active, rng)
    return {"active": active, "partner": partner, "is_receiver": is_recv}


def make_round_inputs_traced(ctx: FLContext, key: torch.Tensor,
                             active: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`make_round_inputs` drawn on the device of ``key``: this
    round's [S] bool mask ``active`` (from
    :func:`~repro_torch.core.dropout.availability_step_traced`) and, for a
    pairing strategy, :func:`~repro_torch.core.gossip.pair_sites_traced`'s
    pairing from ``key``; tensors on that device."""
    s = ctx.fed.num_sites
    active = torch.as_tensor(active, dtype=torch.bool, device=key.device)
    partner = torch.arange(s, device=key.device)
    is_recv = torch.zeros(s, dtype=torch.bool, device=key.device)
    if strat_base.get_strategy(ctx.fed.strategy).needs_pairing:
        from repro_torch.core.gossip import pair_sites_traced
        partner, is_recv, _ = pair_sites_traced(key, active)
    return {"active": active, "partner": partner, "is_receiver": is_recv}


def build_fl_round(ctx: FLContext):
    """Returns ``fl_round(fl_state, batches, round_inputs) -> (fl_state, metrics)``.

    ``batches`` leaves are [S, local_steps, per-site batch...] tensors on
    ``ctx.device``; for GCML, ``round_inputs`` also carries ``dcml_batch``
    and ``val_batch`` with [S, per-site batch...] leaves.
    ``metrics["loss"]`` is each site's loss at its last local step, [S];
    a strategy's own metrics (GCML's DCML losses) join it.
    """
    strategy = strat_base.get_strategy(ctx.fed.strategy)
    dp = ctx.privacy

    def site_train_step(row, opt, batch, layout, strat_ref, noise_key=None):
        def lf(params, b):
            loss, metrics = ctx.loss_fn(params, b)
            return loss + strategy.local_loss_extra(params, strat_ref, ctx), metrics

        if dp is not None:
            # DP clipping replaces grad_clip: the clip norm is the
            # mechanism's sensitivity
            g, loss, metrics, gnorm = dp_gradients(lf, row, layout, batch, noise_key, dp)
        else:
            params, leaves = layout.trainable(row)
            loss, metrics = lf(params, batch)
            g = layout.flat_grad(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))
            loss = loss.detach()
            if ctx.grad_clip:
                g, gnorm = clip_by_global_norm(g, ctx.grad_clip)
            else:
                gnorm = torch.zeros((), device=row.device)
        updates, opt = ctx.optimizer.update(g, opt, row)
        return apply_updates(row, updates), opt, {"loss": loss, "grad_norm": gnorm, **metrics}

    def local_phase(fl_state, batches, active):
        flat, layout, opt = fl_state["params"], fl_state["layout"], fl_state["opt"]
        shutdown = ctx.fed.dropout_scenario == "shutdown"
        rkey = None if dp is None else round_key(dp, fl_state["round"])
        losses = []
        for s in range(flat.shape[0]):
            # a fresh buffer: cuDNN picks its algorithms by the weights'
            # alignment, and row s of [S, N] sits off 16 bytes when N is odd;
            # a site's step must not depend on its row (nor on its transport)
            row = flat[s].clone()
            site_opt = {"step": opt["step"][s], "mu": opt["mu"][s], "nu": opt["nu"][s]}
            for k in range(next(iter(batches.values())).shape[1]):
                batch = {name: b[s, k] for name, b in batches.items()}
                key = None if rkey is None else site_step_key(rkey, ctx.dp_site_base + s, k)
                row, site_opt, m = site_train_step(row, site_opt, batch, layout,
                                                   fl_state["strategy"], key)
            losses.append(m["loss"])
            if shutdown and not active[s]:
                continue        # workstation off: the site's state is untouched
            flat[s].copy_(row)
            opt["mu"][s].copy_(site_opt["mu"])
            opt["nu"][s].copy_(site_opt["nu"])
            opt["step"][s] = site_opt["step"]
        return fl_state, {"loss": torch.stack(losses)}

    # the malicious set is a pure function of (plan.seed, num_sites)
    adv = ctx.adversary
    adv_mask = adv.malicious_mask(ctx.fed.num_sites) if adv is not None else None

    def fl_round(fl_state, batches, round_inputs):
        active = np.asarray(round_inputs["active"], bool)
        ri = {**round_inputs, "active": active}
        if adv is not None and adv.flips_labels:
            batches = adv.perturb_batches(batches, adv_mask)
        fl_state = strategy.pre_exchange(fl_state, ri, ctx)
        fl_state, metrics = local_phase(fl_state, batches, active)
        if adv is not None and adv.flips_params:
            # what malicious ACTIVE sites expose to aggregation; the
            # exchange overwrites those rows, so it never persists
            adv.perturb_rows(fl_state["params"], adv_mask & active, fl_state["round"],
                             fl_state["layout"])
        fl_state = strategy.post_exchange(fl_state, ri, ctx)
        fl_state = {**fl_state, "round": fl_state["round"] + 1}
        if "metrics" in fl_state:
            metrics = {**metrics, **fl_state.pop("metrics")}
        return fl_state, metrics

    return fl_round


def global_model(fl_state, ctx: FLContext):
    """Case-weighted global model from the current stacked params (what
    gets served as 'the' model)."""
    eng = get_engine()
    w = ctx.case_weights / torch.sum(ctx.case_weights)
    return eng.unflatten(eng.reduce_flat(fl_state["params"], w), fl_state["layout"])
