"""Sync rounds on the stacked transport, ported from ``repro/core/round_engine.py``.

The reference compiles chunks of rounds into one donated ``lax.scan``
(``_run_sync_scan``, ``_run_compressed_scan``).  PyTorch runs eagerly, so
the port's counterpart is a plain round loop: host numpy batches for the
round are moved to the device, one round runs, and the per-site losses
come back.

- :func:`run_sync`: uncompressed rounds of every ported strategy:
  FedAvg and FedProx under the job's combine rule (Eq. 1 or a robust
  one) and adversary, the individual and pooled baselines, and GCML with
  the host's gossip pairings and its DCML and validation batches.
- :func:`run_compressed`: FedAvg or FedProx with int8 uploads, downloads
  or both.  Sites train under the strategy's local half (``individual``,
  or ``fedprox-local`` with the Eq. 2 anchor re-pinned to each broadcast
  global) and the loop does the exchange: every site's upload ``u`` (its
  delta plus the carried error-feedback residual) is quantized and folded
  by :func:`compressed_fold`, and with downlink compression each site
  installs its quantized delta against the model it holds
  (:func:`down_install`).

Both follow the job's participation schedule (Algorithm-2 availability
intersected with client sampling) and, when sampling thins it, multiply
its ``1/pi`` factors into the Eq. 1 weights.

Each round's history holds its own times: ``batch_s`` (host batch
generation and the copy to the device), ``step_s`` (the round on the
device) and ``wall_s`` (both: the end-to-end round).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.comms.compression import (KEEP_GLOBALS_DEFAULT, Codec,
                                           align_for, chunk_geom)
from repro_torch.core import federation as F
from repro_torch.core.agg_engine import (RavelLayout, get_engine,
                                         normalized_weights, per_site_nbytes)
from repro_torch.core.session import JobResult
from repro_torch.core.stacking import broadcast_to_sites
from repro_torch.core.strategies.base import get_strategy
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round_loop(job, bundle, ctx, masks: np.ndarray, recorder,
                step: Callable[[int, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]],
                on_round: Optional[Callable[[int], None]], pooled: bool = False) -> None:
    """Run ``step(r, batches) -> (per-site losses, extra history keys)``
    for every round, timing each one, and record it.  With ``pooled`` the
    batches are the round's pooled view."""
    for r in range(len(masks)):
        _sync(ctx.device)
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(ctx.device)
             for k, v in bundle.round_batches(r, job.local_steps, pooled).items()}
        _sync(ctx.device)
        t1 = time.perf_counter()
        losses, extra = step(r, b)
        _sync(ctx.device)
        t2 = time.perf_counter()
        recorder.record(r, losses.cpu().numpy(), masks[r],
                        extra={**extra, "batch_s": t1 - t0, "step_s": t2 - t1,
                               "wall_s": t2 - t0})
        if on_round is not None:
            on_round(r)


def _init_state(job, bundle, ctx, init_params):
    params = init_params if init_params is not None else bundle.init_fn(job.seed)
    return F.init_fl_state(ctx, tree_map(lambda t: t.to(ctx.device), params))


def _schedule(job, rounds: int, device: torch.device):
    """The run's [rounds, S] participation masks and, when client sampling
    thins participation, its [rounds, S] ``1/pi`` Eq. 1 factors on
    ``device`` (else None: dense runs keep their weights bit for bit)."""
    masks, scale = job.participation(rounds)
    return masks, (torch.as_tensor(scale, device=device) if job.sampled else None)


def run_sync(job, bundle, scheduler, rounds: int, init_params=None,
             on_round: Optional[Callable[[int], None]] = None) -> JobResult:
    """``rounds`` sync rounds of ``job`` under its strategy.
    ``init_params`` (one unstacked tree) replaces the seeded
    initialization, e.g. to start from parameters converted from the
    reference.  ``on_round(r)`` is called after round ``r`` is recorded,
    outside its timed span (a profiler's ``step``, for one).

    A pooled job trains one site on the sites' batches concatenated; its
    history counts the task's sites in ``active``, as the reference's
    does.  A pairing strategy (GCML) draws each round's pairs from one
    numpy generator seeded by the job's seed, consumed round by round as
    the reference consumes it, and records ``partner`` and
    ``is_receiver``; its
    DCML batch is the round's local step 0 and its validation batch the
    last local step.  ``comm`` is the simulated wire volume of the
    centrally aggregated strategies (fedavg, fedprox), None otherwise."""
    ctx = job.context(bundle)
    strategy = get_strategy(job.strategy)
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    masks, wscale = _schedule(job, rounds, ctx.device)
    pooled = job.strategy == "pooled"
    pair_rng = np.random.default_rng(job.seed)      # consumed round by round
    recorder = job.recorder(rounds, ctx.fed.num_sites)

    def step(r, batches):
        nonlocal state
        # the pooled site trains every round; the availability mask counts
        # the task's sites (the history's "active"), not the one row
        ri = F.make_round_inputs(ctx, np.ones(1, bool) if pooled else masks[r],
                                 rng=pair_rng)
        if strategy.needs_val_batch:
            ri["dcml_batch"] = {k: v[:, 0] for k, v in batches.items()}
            ri["val_batch"] = {k: v[:, -1] for k, v in batches.items()}
        if wscale is not None:
            ri["weight_scale"] = wscale[r]
        state, metrics = fl_round(state, batches, ri)
        extra = {k: v.cpu().tolist() for k, v in metrics.items() if k.startswith("dcml_")}
        if strategy.needs_pairing:
            extra["partner"] = [int(v) for v in ri["partner"]]
            extra["is_receiver"] = [bool(v) for v in ri["is_receiver"]]
        return metrics["loss"], extra

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round, pooled=pooled)
    global_params = F.global_model(state, ctx)
    comm = None
    if job.strategy in ("fedavg", "fedprox"):
        nbytes = per_site_nbytes(broadcast_to_sites(global_params, 1))
        uploads = int(np.asarray(masks).sum())
        comm = {"upload_bytes": uploads * nbytes, "download_bytes": uploads * nbytes,
                "total_bytes": 2 * uploads * nbytes, "upload_count": uploads,
                "download_count": uploads, "compression": "none",
                "down_compression": "none", "simulated": True}
    return recorder.result(global_params, transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm)


# ---------------------------------------------------------------------------
# On-device int8 codec: the wire codec's per-leaf chunk geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Where every element of a ``[.., N]`` buffer sits in the
    quantization chunk matrices, grouped by chunk width as the reference's
    ``_qdq_tree`` groups them.

    Each leaf is cut by :func:`chunk_geom` into whole rows of its own
    (chunks never cross leaves, so grouping changes no value) and is read
    in the reference's element order (:func:`repro_torch.convert.reference_order`:
    conv weights are OIDHW here and DHWIO there), so every chunk holds
    the elements the reference's chunk holds and the scales agree.
    ``groups`` is ``((width, rows, gather), ...)``: ``gather`` [rows * width]
    indexes the buffer with one zero appended (index N pads a leaf's last
    row).  ``scatter`` [N] is each element's place in the groups' matrices
    laid end to end.  Packing is one gather per group, unpacking one
    gather in all.  ``leaves`` gives each leaf's place in the matrices:
    ``(group, first row, rows, width)``.  ``reorder=False`` reads every
    leaf in its own order, for a buffer that already holds the reference's
    layout (the wire's)."""

    groups: Tuple[Tuple[int, int, torch.Tensor], ...]
    scatter: torch.Tensor
    leaves: Tuple[Tuple[int, int, int, int], ...] = ()

    @classmethod
    def of(cls, layout: RavelLayout, chunk: int, align: int,
           device: torch.device, reorder: bool = True) -> "ChunkPlan":
        by_width: Dict[int, List[np.ndarray]] = {}
        places = []
        for shape, offset in zip(layout.shapes, layout.offsets):
            n = int(np.prod(shape, dtype=np.int64))
            rows, width = chunk_geom(n, chunk, align)
            idx = np.arange(offset, offset + n, dtype=np.int64)
            order = convert.reference_order(shape) if reorder else None
            if order is not None:
                idx = idx.reshape(shape).transpose(order).reshape(-1)
            parts = by_width.setdefault(width, [])
            places.append((width, sum(p.size for p in parts) // width, rows))
            parts.extend([idx, np.full(rows * width - n, layout.n, np.int64)])
        groups, scatter, base = [], np.empty(layout.n, np.int64), 0
        for width, parts in by_width.items():
            gather = np.concatenate(parts)
            real = gather < layout.n
            scatter[gather[real]] = base + np.flatnonzero(real)
            base += gather.size
            groups.append((width, gather.size // width, torch.from_numpy(gather).to(device)))
        group_of = {width: i for i, width in enumerate(by_width)}
        leaves = tuple((group_of[w], row, rows, w) for w, row, rows in places)
        return cls(tuple(groups), torch.from_numpy(scatter).to(device), leaves)

    def pack(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``[.., N]`` -> one zero-padded ``[.., rows, width]`` fp32 matrix
        per group."""
        padded = torch.nn.functional.pad(flat, (0, 1))
        return [padded.index_select(-1, gather).unflatten(-1, (rows, width))
                for width, rows, gather in self.groups]

    def unpack(self, mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`pack` (the padding is dropped)."""
        return torch.cat([m.flatten(-2) for m in mats], -1).index_select(-1, self.scatter)


def compressed_fold(u: torch.Tensor, w: torch.Tensor,
                    plan: ChunkPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's server step on every site's upload ``u`` [S, N]:
    quantize each site's chunks, dequantize them and fold Eq. 1 at weights
    ``w`` [S].  Returns ``(g [N], residual [S, N])`` with ``g = sum_s w_s *
    deQ(Q(u_s))`` and ``residual = u - deQ(Q(u))``.  Two launches per chunk
    width (``quantize_int8``, ``fedagg_dequant``): the kernels on CUDA, the
    plain versions on the CPU."""
    g_mats, r_mats = [], []
    for mat in plan.pack(u):
        s, rows, width = mat.shape
        q, sc = ops.quantize_int8(mat.view(s * rows, width))
        g, r = ops.fedagg_dequant(q.view(s, rows, width), sc.view(s, rows), mat, w)
        g_mats.append(g)
        r_mats.append(r)
    return plan.unpack(g_mats), plan.unpack(r_mats)


def down_install(g: torch.Tensor, held: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """Every site's compressed install: the model it holds (``held``
    [S, N]) plus the quantized delta of the global ``g`` [N] against it.
    Feeding the result back as the next round's ``held`` is the downlink
    error-feedback recurrence ``held <- held + deQ(Q(g - held))``.  Two
    launches per chunk width (``quantize_int8``, ``dequant_install``)."""
    out = []
    for d, h in zip(plan.pack(g[None] - held), plan.pack(held)):
        s, rows, width = d.shape
        q, sc = ops.quantize_int8(d.view(s * rows, width))
        out.append(ops.dequant_install(q.view(s, rows, width), sc.view(s, rows), h))
    return plan.unpack(out)


def encoded_nbytes(shapes: Sequence[Tuple[int, ...]], chunk: int, align: int) -> int:
    """Wire payload bytes of ONE quantized model with leaves of ``shapes``:
    1-byte values plus an fp32 scale per chunk row."""
    total = 0
    for shape in shapes:
        rows, width = chunk_geom(int(np.prod(shape, dtype=np.int64)), chunk, align)
        total += rows * width + rows * 4
    return total


def bootstrap_masks(masks: np.ndarray, keep: int) -> np.ndarray:
    """[rounds, S]: which (round, site) exchanges bootstrap dense under
    bidirectional compression: the site's previous participation is
    ``keep`` or more rounds back, or it never participated."""
    rounds, s = masks.shape
    last = np.full(s, -keep, np.int64)          # "never": forces bootstrap
    boot = np.zeros((rounds, s), bool)
    for r in range(rounds):
        boot[r] = masks[r] & (r - last >= keep)
        last[masks[r]] = r
    return boot


def run_compressed(job, bundle, scheduler, rounds: int, codec: Codec,
                   down_codec: Optional[Codec] = None, init_params=None,
                   on_round: Optional[Callable[[int], None]] = None) -> JobResult:
    """``rounds`` sync FedAvg or FedProx rounds with int8 uploads
    (``codec``), int8 downloads (``down_codec``) or both; arguments as
    :func:`run_sync`.

    The chunk layout follows the job's device as the reference's follows
    its backend: ``align=128`` and the CUDA kernels on a card, ``align=1``
    and their plain versions on the CPU.  The values are the same under
    both; the byte counts are each layout's own.

    Up only: ``u = params - ref + residual``, and the server's reference
    ``ref`` (the global model) advances by the fold.  With the downlink,
    every site holds its own install ``held``: uploads anchor to it, the
    global is ``g = sum_s w_s (anchor_s + deQ(u_s))``, and each active site
    installs ``held + deQ(Q(g - held))``.  A site whose last exchange is
    ``KEEP_GLOBALS_DEFAULT`` rounds old or more (round 0 for everyone)
    bootstraps dense both ways.  Without the uplink, uploads are dense
    and ``g`` is the plain Eq. 1 fold.  The error-feedback residual is
    replaced on active rows only; inactive rows keep their weights.

    FedProx trains its local half (``fedprox-local``): its Eq. 2 anchor
    starts at the initial model and is re-pinned to each round's exact
    global ``g``, one anchor for every site even when each installs its
    own quantized copy, as the reference's engine broadcasts it."""
    prox = job.strategy == "fedprox"
    ctx = job.context(bundle, strategy="fedprox-local" if prox else "individual")
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks, wscale = _schedule(job, rounds, ctx.device)
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    engine = get_engine()
    align = align_for(ctx.device)
    up = codec.name != "none"
    down = down_codec is not None and down_codec.name != "none"
    dev = ctx.device
    plan = ChunkPlan.of(layout, codec.chunk, align, dev) if up else None
    d_plan = None
    if down:
        d_plan = (plan if up and down_codec.chunk == codec.chunk
                  else ChunkPlan.of(layout, down_codec.chunk, align, dev))
    error_feedback = bool(job.error_feedback)
    s, n = state["params"].shape
    ref = torch.zeros((n,), dtype=torch.float32, device=dev)   # round 0: zeros
    res = torch.zeros((s, n), dtype=torch.float32, device=dev)
    held = torch.zeros((s, n), dtype=torch.float32, device=dev) if down else None
    boot_mask = bootstrap_masks(masks, KEEP_GLOBALS_DEFAULT) if down else None

    def step(r, batches):
        nonlocal state, ref, res, held
        active = np.asarray(masks[r], bool)
        state, metrics = fl_round(state, batches, F.make_round_inputs(ctx, active))
        params = state["params"]
        w = normalized_weights(ctx.case_weights, active,
                               None if wscale is None else wscale[r])
        act = torch.as_tensor(active, device=dev)[:, None]
        if down:
            boot = torch.as_tensor(boot_mask[r], device=dev)[:, None]
            # upload anchor: the site's own install; a bootstrap row is dense
            anchor = torch.where(boot, torch.zeros_like(held), held)
            if up:
                gdelta, new_res = compressed_fold(params - anchor + res, w, plan)
                if error_feedback:
                    res = torch.where(act, new_res, res)
                ref = engine.reduce_flat(anchor, w) + gdelta
            else:
                ref = engine.reduce_flat(params, w)
            inst = torch.where(boot, ref[None], down_install(ref, held, d_plan))
            held = torch.where(act, inst, held)
            rows = inst
        else:
            gdelta, new_res = compressed_fold(params - ref[None] + res, w, plan)
            if error_feedback:
                res = torch.where(act, new_res, res)
            ref = ref + gdelta
            rows = ref[None].expand(s, n)
        for i in np.flatnonzero(active):
            params[i].copy_(rows[i])       # broadcast; AdamW moments are kept
        if prox:                           # next round's Eq. 2 anchor
            state = {**state, "strategy": {"global": ref}}
        out = {"upload_bytes": int(round_up[r])}
        if down:
            out["download_bytes"] = int(round_down[r])
        return metrics["loss"], out

    # host-precomputed per-round wire bytes, as the reference counts them;
    # a bootstrap download is the dense fp32 model
    dense = 4 * n                          # init_fl_state holds fp32 rows
    up_bytes = encoded_nbytes(layout.shapes, codec.chunk, align) if up else dense
    round_up = masks.sum(axis=1).astype(np.int64) * up_bytes
    if down:
        down_bytes = encoded_nbytes(layout.shapes, down_codec.chunk, align)
        round_down = np.where(masks, np.where(boot_mask, dense, down_bytes), 0).sum(axis=1)
    else:
        round_down = masks.sum(axis=1).astype(np.int64) * dense

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round)
    uploads = int(masks.sum())
    comm = {"upload_bytes": int(round_up.sum()),
            "upload_raw_bytes": uploads * dense,
            "download_bytes": int(round_down.sum()),
            "download_raw_bytes": uploads * dense,
            "total_bytes": int(round_up.sum() + round_down.sum()),
            "upload_count": uploads, "download_count": uploads,
            "compression": codec.name,
            "down_compression": down_codec.name if down else "none",
            "simulated": True}
    return recorder.result(engine.unflatten(ref, layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm)
