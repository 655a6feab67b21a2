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

Gradient accumulation (``FLContext.microbatch``): a site batch larger
than the microbatch is split into ``bsz // microbatch`` parts; each
part's gradient, cast to ``accum_dtype``, is added into a zero
accumulator of that dtype, which is divided by their count; the loss is
the parts' mean and the metrics are the last part's.  DP-SGD and a
microbatch together raise the reference's ``ValueError``.

The reference vmaps the site axis.  The port runs the sites one after
another, which is the same math with one site's activations at a time
(a full-width SA-Net step at 128^3 holds several GB of them).  Every
site's weights are a row of one ``[S, N]`` buffer (fp32, or bf16 for
the ``mixed`` and ``bf16_train`` policies' bf16 trees; a tree of bf16
and fp32 leaves rides an fp32 buffer whose bf16 leaves are rounded where
the reference rounds them: ``RavelLayout.round_``), and so are the
optimizer's moments (in its ``state_dtype``): a site step differentiates
with respect to per-leaf views of its row, clips and updates the flat
row, and the aggregation kernel then reads the buffer itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
from repro_torch.tree import tree_leaves


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
    microbatch: Optional[int] = None           # per-site microbatch for grad accumulation
    accum_dtype: torch.dtype = torch.float32   # grad-accumulator dtype (bf16 for bf16_train)

    def scalar_loss_fn(self, params, batch):
        return self.loss_fn(params, batch)[0]

    def logits_fn(self, params, batch):
        return self.forward_fn(params, batch)[1:]


def init_fl_state(ctx: FLContext, params) -> Dict:
    """Round-0 federated state: ``params`` (one unstacked tree) on every
    site (the paper's same-init FedAvg), as rows of an [S, N] buffer."""
    s = ctx.fed.num_sites
    dtypes = {x.dtype for x in tree_leaves(params)}
    if not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError("the round loop trains fp32 or bf16 parameters; got "
                        f"{sorted(str(d) for d in dtypes)}")
    flat, layout = get_engine().flatten(broadcast_to_sites(params, s))
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


# elements a slice of the optimizer's update: its fp32 temporaries are a
# slice's, not the row's (a row of a full-width model is billions)
UPDATE_SLICE = 1 << 26


def _update_in_slices(optimizer: Optimizer, g: torch.Tensor, opt: Dict,
                      row: torch.Tensor):
    """``optimizer.update`` and ``apply_updates`` on the flat row, one slice
    at a time, into a new row and new state: the same values as the whole
    row's, since every operation of the update is elementwise."""
    new_row = torch.empty_like(row)
    rows = {k for k, v in opt.items() if v.dim()}          # the moments, not the step
    new = {k: torch.empty_like(opt[k]) for k in rows}
    for lo in range(0, row.numel(), UPDATE_SLICE):
        sl = slice(lo, lo + UPDATE_SLICE)
        u, state = optimizer.update(g[sl], {k: v[sl] if k in rows else v
                                            for k, v in opt.items()}, row[sl])
        new_row[sl] = apply_updates(row[sl], u)
        for k, v in state.items():
            if k in rows:
                new[k][sl] = v
            else:
                new[k] = v
    return new_row, new


def build_fl_round(ctx: FLContext, remat_local: bool = False):
    """Returns ``fl_round(fl_state, batches, round_inputs) -> (fl_state, metrics)``.

    ``batches`` leaves are [S, local_steps, per-site batch...] tensors on
    ``ctx.device``; for GCML, ``round_inputs`` also carries ``dcml_batch``
    and ``val_batch`` with [S, per-site batch...] leaves.
    ``metrics["loss"]`` is each site's loss at its last local step, [S];
    a strategy's own metrics (GCML's DCML losses) join it.
    ``remat_local`` recomputes each site step's forward in its backward
    (``torch.utils.checkpoint``) rather than keeping its activations, where
    the reference checkpoints its site step: the values do not change.
    """
    strategy = strat_base.get_strategy(ctx.fed.strategy)
    dp = ctx.privacy
    if dp is not None and ctx.microbatch:
        raise ValueError("DP-SGD composes its own per-example/per-site "
                         "clipping; microbatch gradient accumulation is "
                         "not supported alongside it")

    def lf(params, b, strat_ref):
        loss, metrics = ctx.loss_fn(params, b)
        return loss + strategy.local_loss_extra(params, strat_ref, ctx), metrics

    def grad_of(row, layout, batch, strat_ref):
        """(the flat gradient in the layout's dtypes, loss, metrics)"""
        params, leaves = layout.trainable(row)
        if remat_local:
            loss, metrics = checkpoint(lf, params, batch, strat_ref, use_reentrant=False)
        else:
            loss, metrics = lf(params, batch, strat_ref)
        g = layout.flat_grad(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))
        return g, loss.detach(), metrics

    def site_train_step(row, opt, batch, layout, strat_ref, noise_key=None):
        if dp is not None:
            # DP clipping replaces grad_clip: the clip norm is the
            # mechanism's sensitivity
            g, loss, metrics, gnorm = dp_gradients(lambda p, b: lf(p, b, strat_ref), row,
                                                   layout, batch, noise_key, dp)
        else:
            bsz = next(iter(batch.values())).shape[0]
            if ctx.microbatch and ctx.microbatch < bsz:
                # the parts' gradients added in accum_dtype, then averaged
                n = bsz // ctx.microbatch
                g = torch.zeros((layout.n,), dtype=ctx.accum_dtype, device=row.device)
                loss = torch.zeros((), device=row.device)
                for i in range(n):
                    mb = {k: v[i * ctx.microbatch:(i + 1) * ctx.microbatch]
                          for k, v in batch.items()}
                    gi, li, metrics = grad_of(row, layout, mb, strat_ref)
                    g += gi.to(ctx.accum_dtype)
                    loss = loss + li
                g, loss = g / n, loss / n
                narrow = None           # the accumulator's one dtype
            else:
                g, loss, metrics = grad_of(row, layout, batch, strat_ref)
                narrow = layout          # the leaves' own dtypes
            if ctx.grad_clip:
                g, gnorm = clip_by_global_norm(g, ctx.grad_clip)
                if narrow is not None:
                    narrow.round_(g)
            else:
                gnorm = torch.zeros((), device=row.device)
        row, opt = _update_in_slices(ctx.optimizer, g, opt, row)
        return layout.round_(row), opt, {"loss": loss, "grad_norm": gnorm, **metrics}

    def local_phase(fl_state, batches, active):
        flat, layout, opt = fl_state["params"], fl_state["layout"], fl_state["opt"]
        shutdown = ctx.fed.dropout_scenario == "shutdown"
        rkey = None if dp is None else round_key(dp, fl_state["round"])
        losses = []
        for s in range(flat.shape[0]):
            # cuDNN picks its algorithms by the weights' alignment, and row s
            # of [S, N] sits off 16 bytes when N is odd: such a row steps from
            # a fresh buffer, so that a site's step does not depend on its row
            # (nor on its transport).  The step writes a new row.
            row = flat[s] if flat[s].data_ptr() % 16 == 0 else flat[s].clone()
            site_opt = {k: v[s] for k, v in opt.items()}
            for k in range(next(iter(batches.values())).shape[1]):
                batch = {name: b[s, k] for name, b in batches.items()}
                key = None if rkey is None else site_step_key(rkey, ctx.dp_site_base + s, k)
                row, site_opt, m = site_train_step(row, site_opt, batch, layout,
                                                   fl_state["strategy"], key)
            losses.append(m["loss"])
            if shutdown and not active[s]:
                continue        # workstation off: the site's state is untouched
            flat[s].copy_(row)
            for name, v in site_opt.items():
                opt[name][s] = v
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
