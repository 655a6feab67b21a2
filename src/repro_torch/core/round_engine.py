"""Rounds on the stacked transport, ported from ``repro/core/round_engine.py``.

The reference compiles chunks of rounds into one donated ``lax.scan``
(``_run_sync_scan``, ``_run_compressed_scan``, ``_run_buffered_scan``).
PyTorch runs eagerly, so the port's counterpart is a plain round loop:
host numpy batches for the round are moved to the device, one round
runs, and the per-site losses come back.

- :func:`run_sync`: uncompressed rounds of every ported strategy:
  FedAvg and FedProx under the job's combine rule (Eq. 1 or a robust
  one) and adversary, the individual and pooled baselines, and GCML with
  the host's gossip pairings and its DCML and validation batches; with
  ``device_data`` the batches, the Algorithm-2 masks and the pairings are
  drawn on the device from the reference's threefry keys.
- :func:`run_compressed`: FedAvg or FedProx with int8, fp8 or
  ``topk-fixed`` uploads, downloads or both, through the codecs'
  on-device twins (:class:`DeviceCodec`).  Sites train under the
  strategy's local half (``individual``, or ``fedprox-local`` with the
  Eq. 2 anchor re-pinned to each broadcast global) and the loop does the
  exchange: every site's upload ``u`` (its delta plus the carried
  error-feedback residual) is compressed and folded (int8:
  :func:`compressed_fold`; fp8 and top-k: their dense rows through
  ``fedagg``), and with downlink compression each site installs its
  compressed delta against the model it holds (int8:
  :func:`down_install`).  Under a pods topology the uploads are
  compressed and decoded (int8: :func:`qdq`) and folded in two tiers
  (``reduce_pods_flat``) instead of by the fused ``fedagg_dequant``.
- :func:`run_buffered`: FedBuff rounds of FedAvg, dense, int8 or fp8
  (the reference's buffered scan).  Sites train, then arrive in a seeded
  order; each admitted arrival folds at its staleness discount, and the
  buffer becomes a new global version every ``buffer_k`` folds.  Which
  arrival folds, rejects or fires is a function of the masks and the
  arrival orders only, so the host works the schedule out
  (:func:`buffered_schedule`) and the card runs the folds.
- :func:`run_compressed_host`: the reference's host loop for sync
  rounds, through the wire codec itself (``topk-sparse``, and
  ``round_engine="loop"``).
- :func:`run_buffered_host`: the reference's buffered host loop (a codec
  with a ``max_staleness`` past the decode ring, the top-k codecs,
  ``round_engine="loop"``): the wire codec a site and a version-keyed
  ring of globals.
- :func:`execute_sharded`: ``shard_sites=True``, the site rows in blocks
  over the devices and only each round's participants trained and folded
  (``fedagg`` a pod a device, then the inter-pod combine).

:func:`engine_for` and :func:`host_loop_for` route a job as the
reference's ``execute_stacked`` does.

All follow the job's participation schedule (Algorithm-2 availability,
the pod tier's churn composed in, intersected with client sampling) and,
when sampling thins it, multiply its ``1/pi`` factors into the Eq. 1
weights.

Each round's history holds its own times: ``batch_s`` (host batch
generation and the copy to the device), ``step_s`` (the round on the
device) and ``wall_s`` (both: the end-to-end round).

With a ``checkpoint_dir`` every engine but the buffered host loop writes
the reference's checkpoints on its ``ckpt_every`` grid (rounds ``r %
ckpt_every == 0``, where the reference's scans cut their chunks): the
global model (tag ``"global"``, the reference's layout) and the engine's
carry (tag ``"driver_state"``, meta ``engine`` and ``dp``).  Given a
``resume_round`` an engine checks both meta fields against the job
(:func:`~repro_torch.core.session.check_engine_tag`,
:func:`~repro_torch.core.session.check_privacy_tag`), reloads the carry
and runs from the round after it; the engine tags are the reference's
(``"sync-scan"`` / ``"sync-loop"``, ``"compressed-scan"`` /
``"compressed-scan-bidir"``, ``"compressed-loop"`` /
``"compressed-loop-bidir"``, ``"buffered-scan"``).  A resumed run's
``comm`` counts only the rounds it ran.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.comms.compression import (KEEP_GLOBALS_DEFAULT, Codec, DownlinkCompressor,
                                           UploadCompressor, WirePlan, chunk_geom,
                                           decode_download, topk_count)
from repro_torch.core import federation as F
from repro_torch.core.agg_engine import (RavelLayout, StreamingAccumulator, get_engine,
                                         normalized_weights, per_site_nbytes, ravel, unravel)
from repro_torch.core.session import (BufferedScheduler, JobResult, check_engine_tag,
                                      check_privacy_tag)
from repro_torch.core.topology import simulated_pods_comm
from repro_torch.core.stacking import broadcast_to_sites
from repro_torch.core.strategies.base import get_strategy
from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round_loop(job, bundle, ctx, masks: np.ndarray, recorder,
                step: Callable[[int, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]],
                on_round: Optional[Callable[[int], None]], pooled: bool = False,
                start: int = 0, global_fn: Optional[Callable] = None,
                save: Optional[Callable[[int], None]] = None,
                batches_fn: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None) -> None:
    """Run ``step(r, batches) -> (per-site losses, extra history keys)``
    for every round from ``start``, timing each one, and record it with
    ``masks[r]`` (which ``step`` may write); then, outside the timed span,
    the recorder saves ``global_fn()`` and ``save(r)`` writes the engine's
    carry (each on the checkpoint grid).  The batches are the host
    generator's, copied to the device (with ``pooled``, the round's pooled
    view), or ``batches_fn(r)``'s, drawn on the device."""
    for r in range(start, len(masks)):
        _sync(ctx.device)
        t0 = time.perf_counter()
        if batches_fn is not None:
            b = batches_fn(r)
        else:
            b = {k: torch.from_numpy(v).to(ctx.device)
                 for k, v in bundle.round_batches(r, job.local_steps, pooled).items()}
        _sync(ctx.device)
        t1 = time.perf_counter()
        losses, extra = step(r, b)
        _sync(ctx.device)
        t2 = time.perf_counter()
        recorder.record(r, losses.cpu().numpy(), masks[r], global_fn=global_fn,
                        extra={**extra, "batch_s": t1 - t0, "step_s": t2 - t1,
                               "wall_s": t2 - t0})
        if save is not None:
            save(r)
        if on_round is not None:
            on_round(r)


def _init_state(job, bundle, ctx, init_params):
    params = init_params if init_params is not None else bundle.init_fn(job.seed)
    return F.init_fl_state(ctx, tree_map(lambda t: t.to(ctx.device), params))


# ---------------------------------------------------------------------------
# Checkpoints: the engines' carries on the ckpt_every grid
# ---------------------------------------------------------------------------


def _fl_tree(state) -> Dict:
    """The FL state as a checkpoint tree: the rows, AdamW's moments and
    steps, the strategy's state (FedProx's anchor) and the round counter."""
    return {"params": state["params"], "opt": state["opt"], "strategy": state["strategy"],
            "round": torch.tensor(int(state["round"]))}


def _restore_fl(state, saved, device: torch.device) -> Dict:
    """``state`` with a checkpoint tree's values (numpy leaves) copied in."""
    state["params"].copy_(torch.from_numpy(np.asarray(saved["params"])))
    for k, v in saved["opt"].items():
        state["opt"][k].copy_(torch.from_numpy(np.asarray(v)))
    strategy = tree_map(lambda v: _dev(v, device), saved["strategy"])
    return {**state, "strategy": strategy, "round": int(saved["round"])}


def _dev(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)).to(device)


def _resume(job, recorder, tag: str, resume_round: Optional[int], like):
    """``(saved tree or None, its meta, the first round to run)``: a resume
    from ``driver_state`` round ``resume_round`` checks the engine tag and
    the DP settings the checkpoint was written with (the reference's
    messages) before loading into the structure of ``like``."""
    if resume_round is None:
        return None, {}, 0
    meta = recorder.store.meta("driver_state", resume_round)
    check_engine_tag(meta, tag)
    check_privacy_tag(meta, job.dp_tag())
    saved, _ = recorder.store.load("driver_state", resume_round, like)
    return saved, meta, resume_round + 1


def _saver(job, recorder, tag: str, tree_fn: Callable[[], Dict],
           meta_fn: Optional[Callable[[], Dict]] = None) -> Callable[[int], None]:
    """``save(r)``: the engine's carry ``tree_fn()`` as round ``r``'s
    ``driver_state`` (on the grid only), tagged with the engine and the
    job's DP settings."""
    def save(r: int) -> None:
        recorder.save_state(r, tree_fn, meta={"engine": tag, "dp": job.dp_tag(),
                                              **(meta_fn() if meta_fn else {})})
    return save


def _reference_tree(fn: Callable) -> Callable:
    """The recorder's ``global_fn``: the global model in the reference's
    layout, as the socket transports save it."""
    return lambda: convert.to_reference(fn())


def _schedule(job, rounds: int, device: torch.device):
    """The run's [rounds, S] participation masks and, when client sampling
    thins participation, its [rounds, S] ``1/pi`` Eq. 1 factors on
    ``device`` (else None: dense runs keep their weights bit for bit)."""
    masks, scale = job.participation(rounds)
    return masks, (torch.as_tensor(scale, device=device) if job.sampled else None)


def run_sync(job, bundle, scheduler, rounds: int, codec: Optional[Codec] = None,
             down_codec: Optional[Codec] = None, init_params=None,
             on_round: Optional[Callable[[int], None]] = None,
             resume_round: Optional[int] = None) -> JobResult:
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
    centrally aggregated strategies (fedavg, fedprox), None otherwise.

    ``resume_round`` re-enters from that round's checkpoint (the FL state,
    tag ``"sync-loop"`` under ``round_engine="loop"``, else ``"sync-scan"``);
    a pairing strategy first replays the draws of the rounds before, so the
    gossip schedule continues where the dead run left off.

    With ``job.device_data`` the round's inputs come from the device, as in
    the reference's scan: from ``data_key = fold_in(key(seed), 7)`` each
    round draws ``k_av, k_pair, k_data = split(fold_in(data_key, r), 3)``;
    under ``max_dropout`` the carried active mask (all ones before round
    0) takes one :func:`~repro_torch.core.dropout.availability_step_traced`
    step on ``k_av``, the pairing comes from ``k_pair``
    (:func:`~repro_torch.core.federation.make_round_inputs_traced`) and the
    batches from ``bundle.traced_stacked(k_data, K, B)``, drawn on the
    device inside ``batch_s``.  The history and ``comm`` count the masks
    drawn, and the carry holds the active mask too."""
    ctx = job.context(bundle)
    strategy = get_strategy(job.strategy)
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    masks, wscale = _schedule(job, rounds, ctx.device)
    pooled = job.strategy == "pooled"
    pair_rng = np.random.default_rng(job.seed)      # consumed round by round
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    tag = "sync-loop" if job.round_engine == "loop" else "sync-scan"
    device_data = bool(job.device_data)
    dev = ctx.device
    if device_data:
        from repro_torch.core import prng
        from repro_torch.core.dropout import availability_step_traced
        data_key = prng.fold_in(prng.key(job.seed, device=dev), 7)
        active = torch.ones(ctx.fed.num_sites, dtype=torch.bool, device=dev)
        masks = np.ones_like(masks)          # each round's row: its draw

    def carry():
        c = {"fl_state": _fl_tree(state)}
        if device_data:
            c["active"] = active
        return c

    saved, _, start = _resume(job, recorder, tag, resume_round, carry())
    if saved is not None:
        state = _restore_fl(state, saved["fl_state"], dev)
        if device_data:
            active = _dev(saved["active"], dev)
        elif strategy.needs_pairing:
            for r in range(start):
                F.make_round_inputs(ctx, masks[r], rng=pair_rng)

    def round_keys(r):
        return prng.split(prng.fold_in(data_key, r), 3)

    def device_batches(r):
        return bundle.traced_stacked(round_keys(r)[2], job.local_steps, job.task.batch)

    def device_inputs(r):
        nonlocal active
        k_av, k_pair, _ = round_keys(r)
        if job.max_dropout:
            active = availability_step_traced(k_av, active, job.max_dropout)
        ri = {k: v.cpu().numpy() for k, v in
              F.make_round_inputs_traced(ctx, k_pair, active).items()}
        masks[r] = ri["active"]
        return ri

    def step(r, batches):
        nonlocal state
        if device_data:
            ri = device_inputs(r)
        else:
            # the pooled site trains every round; the availability mask
            # counts the task's sites (the history's "active"), not the row
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

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round, pooled=pooled,
                start=start, global_fn=_reference_tree(lambda: F.global_model(state, ctx)),
                save=_saver(job, recorder, tag, carry),
                batches_fn=device_batches if device_data else None)
    global_params = F.global_model(state, ctx)
    comm = None
    ran = masks[start:]
    if job.strategy in ("fedavg", "fedprox") and ctx.topology.is_pods:
        comm = simulated_pods_comm(ctx.topology, ran,
                                   per_site_nbytes(broadcast_to_sites(global_params, 1)))
    elif job.strategy in ("fedavg", "fedprox"):
        nbytes = per_site_nbytes(broadcast_to_sites(global_params, 1))
        uploads = int(np.asarray(ran).sum())
        comm = {"upload_bytes": uploads * nbytes, "download_bytes": uploads * nbytes,
                "total_bytes": 2 * uploads * nbytes, "upload_count": uploads,
                "download_count": uploads, "compression": "none",
                "down_compression": "none", "simulated": True}
    return recorder.result(global_params, transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           resumed_from=resume_round, privacy=job.privacy_report(rounds))


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
    layout (the wire's).  ``whole=True`` chunks the whole buffer as ONE
    leaf (in the reference's element order), as the reference's buffered
    rounds chunk their flat vector."""

    groups: Tuple[Tuple[int, int, torch.Tensor], ...]
    scatter: torch.Tensor
    leaves: Tuple[Tuple[int, int, int, int], ...] = ()

    @classmethod
    def of(cls, layout: RavelLayout, chunk: int, align: int,
           device: torch.device, reorder: bool = True, whole: bool = False) -> "ChunkPlan":
        by_width: Dict[int, List[np.ndarray]] = {}
        places = []
        leaves = []
        for shape, offset in zip(layout.shapes, layout.offsets):
            idx = np.arange(offset, offset + int(np.prod(shape, dtype=np.int64)),
                            dtype=np.int64)
            order = convert.reference_order(shape) if reorder else None
            if order is not None:
                idx = idx.reshape(shape).transpose(order).reshape(-1)
            leaves.append(idx)
        if whole:
            leaves = [np.concatenate(leaves)]
        for idx in leaves:
            n = idx.size
            rows, width = chunk_geom(n, chunk, align)
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


def qdq(u: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """``deQ(Q(u))`` for every row of ``u`` [.., N], chunked by ``plan``:
    one ``quantize_int8`` and one ``dequantize_int8`` launch per chunk
    width (the plain versions on the CPU).  ``u - qdq(u)`` is the residual
    that ``fedagg_dequant`` gives, bit for bit."""
    out = []
    for mat in plan.pack(u):
        q, sc = ops.quantize_int8(mat.reshape(-1, mat.shape[-1]))
        out.append(ops.dequantize_int8(q, sc).view(mat.shape))
    return plan.unpack(out)


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


def qdq_fp8(u: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """``deQ(Q(u))`` in fp8 for every row of ``u`` [.., N], chunked by
    ``plan`` (the reference's ``_qdq_tree``: one call per chunk width),
    plain PyTorch on every device, bit for bit the wire codec's."""
    return plan.unpack([ref.quantize_dequantize_fp8_ref(m) for m in plan.pack(u)])


class DeviceCodec:
    """The stacked transport's twin of one wire codec (int8, fp8 or
    ``topk-fixed``) over ``[S, N]`` buffers of the port's layout, the
    reference's ``_qdq_tree`` / ``_topk_tree`` with the wire's geometry.

    int8 is chunked at the device's alignment and runs the fused kernels
    (:func:`compressed_fold`, :func:`down_install`); fp8 is chunked at
    ``align=1`` and top-k selects in the reference's element order
    (:class:`~repro_torch.comms.compression.TopKPlan` on the wire's
    gather), both plain PyTorch, their dense rows folded by
    ``reduce_flat`` (``fedagg``).  ``nbytes`` is one upload's payload."""

    def __init__(self, codec: Codec, layout: RavelLayout, device: torch.device):
        self.name = codec.name
        if self.name == "topk-fixed":
            self.wire = WirePlan.of(layout, 1024, 1, device, port=True)
            self.topk = self.wire.topk_plan(codec.fraction)
            self.nbytes = 8 * self.topk.kept
        elif self.name in ("int8", "fp8"):
            align = codec.align(device)
            self.plan = ChunkPlan.of(layout, codec.chunk, align, device)
            self.nbytes = encoded_nbytes(layout.shapes, codec.chunk, align)
        else:
            raise ValueError(f"no on-device twin for codec {self.name!r}")

    def deq(self, u: torch.Tensor) -> torch.Tensor:
        """``deQ(Q(u))`` of every row of ``u`` [S, N]."""
        if self.name == "int8":
            return qdq(u, self.plan)
        if self.name == "fp8":
            return qdq_fp8(u, self.plan)
        w = self.wire.to_wire(u)
        return self.wire.to_port(torch.where(self.topk.mask(w), w, torch.zeros_like(w)))

    def fold(self, u: torch.Tensor, w: torch.Tensor, engine) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(sum_s w_s deQ(Q(u_s)), u - deQ(Q(u)))``."""
        if self.name == "int8":
            return compressed_fold(u, w, self.plan)
        deq = self.deq(u)
        return engine.reduce_flat(deq, w), u - deq

    def install(self, g: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
        """``held + deQ(Q(g - held))`` for every row."""
        if self.name == "int8":
            return down_install(g, held, self.plan)
        return held + self.deq(g[None] - held)


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


def topk_nbytes(shapes: Sequence[Tuple[int, ...]], fraction: float) -> int:
    """Wire payload bytes of ONE top-k model with leaves of ``shapes``: a
    uint32 index and an fp32 value a kept entry."""
    return sum(8 * topk_count(fraction, int(np.prod(sh, dtype=np.int64))) for sh in shapes)


def run_compressed(job, bundle, scheduler, rounds: int, codec: Codec,
                   down_codec: Optional[Codec] = None, init_params=None,
                   on_round: Optional[Callable[[int], None]] = None,
                   resume_round: Optional[int] = None) -> JobResult:
    """``rounds`` sync FedAvg or FedProx rounds with int8, fp8 or
    ``topk-fixed`` uploads (``codec``), downloads (``down_codec``) or both,
    through the codecs' on-device twins (:class:`DeviceCodec`); arguments as
    :func:`run_sync`.

    int8's chunk layout follows the job's device as the reference's follows
    its backend: ``align=128`` and the CUDA kernels on a card, ``align=1``
    and their plain versions on the CPU.  The values are the same under
    both; the byte counts are each layout's own.  fp8 is ``align=1`` on
    both.

    Up only: ``u = params - ref + residual``, and the server's reference
    ``ref`` (the global model) advances by the fold.  With the downlink,
    every site holds its own install ``held``: uploads anchor to it, the
    global is ``g = sum_s w_s (anchor_s + deQ(u_s))``, and each active site
    installs ``held + deQ(Q(g - held))``.  A site whose last exchange is
    ``KEEP_GLOBALS_DEFAULT`` rounds old or more (round 0 for everyone)
    bootstraps dense both ways.  Without the uplink, uploads are dense
    and ``g`` is the plain Eq. 1 fold.  The error-feedback residual is
    replaced on active rows only; inactive rows keep their weights.
    ``topk-fixed`` uploads go dense (no codec, a zero residual) where the
    wire's would: in round 0 up only, and on the bootstrap rows with the
    downlink.

    FedProx trains its local half (``fedprox-local``): its Eq. 2 anchor
    starts at the initial model and is re-pinned to each round's exact
    global ``g``, one anchor for every site even when each installs its
    own quantized copy, as the reference's engine broadcasts it.

    Under a pods topology every fold is two-tier (``reduce_pods_flat``:
    the site uploads' dequantized values, the anchors and the dense
    uploads alike), so int8 uploads go through :func:`qdq` and not the
    fused ``fedagg_dequant``; ``comm`` gains the per-tier split of
    :func:`~repro_torch.core.topology.simulated_pods_comm`.

    Its carry (tag ``"compressed-scan"``, ``"compressed-scan-bidir"`` with
    the downlink) is the FL state, the server's reference, the residuals
    and, with the downlink, the installs each site holds."""
    prox = job.strategy == "fedprox"
    ctx = job.context(bundle, strategy="fedprox-local" if prox else "individual")
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks, wscale = _schedule(job, rounds, ctx.device)
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    engine = get_engine()
    up = codec.name != "none"
    down = down_codec is not None and down_codec.name != "none"
    dev = ctx.device
    up_codec = DeviceCodec(codec, layout, dev) if up else None
    d_codec = DeviceCodec(down_codec, layout, dev) if down else None
    topk = codec.name == "topk-fixed"
    error_feedback = bool(job.error_feedback)
    s, n = state["params"].shape
    ref = torch.zeros((n,), dtype=torch.float32, device=dev)   # round 0: zeros
    res = torch.zeros((s, n), dtype=torch.float32, device=dev)
    held = torch.zeros((s, n), dtype=torch.float32, device=dev) if down else None
    boot_mask = bootstrap_masks(masks, KEEP_GLOBALS_DEFAULT) if down else None
    topo = job.topo
    pod_ids = topo.pod_of(s) if topo.is_pods else None
    tag = "compressed-scan-bidir" if down else "compressed-scan"

    def carry():
        c = {"fl_state": _fl_tree(state), "reference": ref, "residual": res}
        if down:
            c["held"] = held
        return c

    saved, _, start = _resume(job, recorder, tag, resume_round, carry())
    if saved is not None:
        state = _restore_fl(state, saved["fl_state"], dev)
        ref, res = _dev(saved["reference"], dev), _dev(saved["residual"], dev)
        if down:
            held = _dev(saved["held"], dev)

    def step(r, batches):
        nonlocal state, ref, res, held
        active = np.asarray(masks[r], bool)
        state, metrics = fl_round(state, batches, F.make_round_inputs(ctx, active))
        params = state["params"]
        scale = None if wscale is None else wscale[r]
        w = normalized_weights(ctx.case_weights, active, scale)
        act = torch.as_tensor(active, device=dev)[:, None]

        def fold(x):                       # Eq. 1 over [S, N]: flat or two-tier
            if pod_ids is None:
                return engine.reduce_flat(x, w)
            return engine.reduce_pods_flat(x, ctx.case_weights, active, pod_ids,
                                           topo.num_pods, topo.intra, topo.inter, scale)

        def up_fold(u, dense=None):        # (global delta, residual)
            # ``dense``: True (every row) or [S, 1] rows that skip the codec
            if dense is True:
                return fold(u), u - u
            if pod_ids is None and dense is None:
                return up_codec.fold(u, w, engine)
            deq = up_codec.deq(u)
            if dense is not None:
                deq = torch.where(dense, u, deq)
            return fold(deq), u - deq

        if down:
            boot = torch.as_tensor(boot_mask[r], device=dev)[:, None]
            # upload anchor: the site's own install; a bootstrap row is dense
            anchor = torch.where(boot, torch.zeros_like(held), held)
            if up:
                gdelta, new_res = up_fold(params - anchor + res, boot if topk else None)
                if error_feedback:
                    res = torch.where(act, new_res, res)
                ref = fold(anchor) + gdelta
            else:
                ref = fold(params)
            inst = torch.where(boot, ref[None], d_codec.install(ref, held))
            held = torch.where(act, inst, held)
            rows = inst
        else:
            gdelta, new_res = up_fold(params - ref[None] + res, True if topk and r == 0 else None)
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
    # a bootstrap download, and a top-k bootstrap upload, is the dense model
    dense = 4 * n                          # init_fl_state holds fp32 rows
    up_bytes = up_codec.nbytes if up else dense
    if down:
        per_up = np.where(boot_mask, dense, up_bytes) if topk else np.full(masks.shape, up_bytes)
        round_up = np.where(masks, per_up, 0).sum(axis=1).astype(np.int64)
        round_down = np.where(masks, np.where(boot_mask, dense, d_codec.nbytes), 0).sum(axis=1)
    else:
        per_round = np.full(rounds, up_bytes, np.int64)
        if topk:
            per_round[:1] = dense
        round_up = masks.sum(axis=1).astype(np.int64) * per_round
        round_down = masks.sum(axis=1).astype(np.int64) * dense

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round, start=start,
                global_fn=_reference_tree(lambda: engine.unflatten(ref, layout)),
                save=_saver(job, recorder, tag, carry))
    ran = masks[start:]
    uploads = int(ran.sum())
    up_total, down_total = int(round_up[start:].sum()), int(round_down[start:].sum())
    comm = {"upload_bytes": up_total,
            "upload_raw_bytes": uploads * dense,
            "download_bytes": down_total,
            "download_raw_bytes": uploads * dense,
            "total_bytes": up_total + down_total,
            "upload_count": uploads, "download_count": uploads,
            "compression": codec.name,
            "down_compression": down_codec.name if down else "none",
            "simulated": True}
    if topo.is_pods:
        comm.update(simulated_pods_comm(
            topo, ran, dense, intra_upload_bytes=comm["upload_bytes"],
            intra_download_bytes=comm["download_bytes"] if down else None,
            compression=codec.name, down_compression=comm["down_compression"]))
    return recorder.result(engine.unflatten(ref, layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           resumed_from=resume_round, privacy=job.privacy_report(rounds))


def run_compressed_host(job, bundle, scheduler, rounds: int, codec: Codec,
                        down_codec: Optional[Codec] = None, init_params=None,
                        on_round: Optional[Callable[[int], None]] = None,
                        resume_round: Optional[int] = None) -> JobResult:
    """Sync FedAvg or FedProx rounds with any codec in either direction
    through the wire codec itself, the reference's host loop
    (``StackedTransport._execute_compressed``):
    the path of ``topk-sparse``, and of ``round_engine="loop"``; arguments
    as :func:`run_sync`.

    Every active site's trained row is encoded by its own
    :class:`~repro_torch.comms.compression.UploadCompressor` (the wire's
    layout, a delta against the last broadcast global, or with the downlink
    against the site's own install; dense past the ``KEEP_GLOBALS_DEFAULT``
    window, and a sparsifier's bootstrap dense), decoded on the device and
    folded into its pod's
    :class:`~repro_torch.core.agg_engine.StreamingAccumulator` at its case
    weight (1 under ``intra="uniform"``, times the sampling factor); the
    pods' partials fold into the root at their folded weight (1 under
    ``inter="uniform"``), the flat topology being one pod.  With a download
    codec a :class:`~repro_torch.comms.compression.DownlinkCompressor`
    encodes each active site's install against what it holds, in the
    wire's layout, and the site decodes it; else each active site installs
    the global.  FedProx's Eq. 2 anchor is the exact global.  ``comm`` is
    the compressors' counters.

    Its carry (tag ``"compressed-loop"``, ``"compressed-loop-bidir"`` with
    the downlink) is the FL state, the last broadcast global, each site's
    residual (meta ``has_residual``) and, with the downlink, each site's
    install and the round it acknowledged (meta ``down_acked``), which also
    restores the server's held references; the sites' last rounds (the
    dense-bootstrap window) are replayed from the masks."""
    prox = job.strategy == "fedprox"
    ctx = job.context(bundle, strategy="fedprox-local" if prox else "individual")
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks = job.masks(rounds)
    wscale = job.weight_scale(rounds) if job.sampled else None
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    s, n = state["params"].shape
    topo = job.topo
    pod_of = topo.pod_of(s)
    case_w = np.asarray(job.federation().case_weights())
    comps = [UploadCompressor(codec, job.error_feedback) for _ in range(s)]
    down = down_codec is not None and down_codec.name != "none"
    keep = KEEP_GLOBALS_DEFAULT
    server_down = DownlinkCompressor(down_codec) if down else None
    g = ravel(F.global_model(state, ctx))
    edge = comps[0].plan(unravel(g, layout))
    d_plan = WirePlan.of(edge.wire, 1024, 1, ctx.device, port=False) if down else None
    installs: List = [None] * s          # each site's decoded install, the wire's layout
    acked: List[Optional[int]] = [None] * s
    last_active = np.full(s, -keep, np.int64)
    reference: Optional[torch.Tensor] = None        # the last broadcast global
    tag = "compressed-loop-bidir" if down else "compressed-loop"
    zero = torch.zeros(n, dtype=torch.float32, device=ctx.device)

    def carry():
        c = {"fl_state": _fl_tree(state),
             "reference": reference if reference is not None else zero,
             "residuals": [cp.residual if cp.residual is not None else zero for cp in comps]}
        if down:
            c["down_refs"] = [t if t is not None else unravel(zero, edge.wire) for t in installs]
        return c

    def carry_meta():
        meta = {"has_residual": [cp.residual is not None for cp in comps]}
        if down:
            meta["down_acked"] = list(acked)
        return meta

    saved, meta, start = _resume(job, recorder, tag, resume_round, carry())
    if saved is not None:
        state = _restore_fl(state, saved["fl_state"], ctx.device)
        g = reference = _dev(saved["reference"], ctx.device)
        for i, has in enumerate(meta.get("has_residual", [False] * s)):
            if has:
                comps[i].residual = _dev(saved["residuals"][i], ctx.device)
        for i, a in enumerate(meta.get("down_acked", [None] * s) if down else []):
            if a is not None:
                server_down.restore(i, saved["down_refs"][i], int(a), device=ctx.device)
                installs[i], acked[i] = server_down.held_state(i)[0], int(a)
        for r in range(start):          # the bootstrap window is a function of the masks
            last_active[masks[r]] = r

    def step(r, batches):
        nonlocal state, g, reference
        state, metrics = fl_round(state, batches, F.make_round_inputs(ctx, masks[r]))
        p = state["params"]
        active = [int(i) for i in np.flatnonzero(masks[r])]
        pods = [StreamingAccumulator() for _ in range(topo.num_pods)]
        root = StreamingAccumulator()
        up_before = sum(c.encoded_bytes for c in comps)
        down_before = server_down.encoded_bytes if down else 0
        for site in active:
            if down:    # anchored to its own install; dense past the window
                up_ref = (None if r - int(last_active[site]) >= keep or installs[site] is None
                          else edge.to_port(ravel(installs[site])))
            else:
                up_ref = reference
            enc, cmeta = comps[site].encode(unravel(p[site], layout),
                                            None if up_ref is None else unravel(up_ref, layout))
            decoded = edge.to_port(edge.decode(enc))
            if cmeta.get("delta"):
                decoded = decoded + up_ref
            w = 1.0 if topo.intra == "uniform" else float(case_w[site])
            if wscale is not None:             # Horvitz-Thompson 1/pi factor
                w *= float(wscale[r, site])
            pods[int(pod_of[site])].fold(unravel(decoded, layout), w, owned=True)
        for acc in pods:
            if acc.count:
                pw = 1.0 if topo.inter == "uniform" else acc.weight_total
                root.fold(acc.finalize(), pw, owned=True)
        if root.count:
            g = reference = ravel(root.finalize())
            if down:
                # the socket server's order: advance the round clock, evict
                # stale references, then serve this round's downloads
                server_down.evict_stale(r + 1, keep)
                gw = unravel(edge.to_wire(g), edge.wire)
                for site in active:
                    payload, dmeta = server_down.encode(site, gw, r + 1, acked_round=acked[site])
                    installs[site] = decode_download(payload, dmeta, installs[site], plan=d_plan)
                    acked[site] = r + 1
                    p[site].copy_(edge.to_port(ravel(installs[site])))
            else:
                for site in active:
                    p[site].copy_(g)
            if prox:                               # the exact global, as the engine's
                state = {**state, "strategy": {"global": g}}
        last_active[masks[r]] = r
        out = {"upload_bytes": sum(c.encoded_bytes for c in comps) - up_before}
        if down:
            out["download_bytes"] = server_down.encoded_bytes - down_before
        return metrics["loss"], out

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round, start=start,
                global_fn=_reference_tree(lambda: unravel(g, layout)),
                save=_saver(job, recorder, tag, carry, carry_meta))
    dense = 4 * n
    uploads = sum(c.encodes for c in comps)
    up_bytes = sum(c.encoded_bytes for c in comps)
    down_bytes, down_raw, down_count = ((server_down.encoded_bytes, server_down.raw_bytes,
                                         server_down.encodes) if down
                                        else (uploads * dense, uploads * dense, uploads))
    comm = {"upload_bytes": up_bytes, "upload_raw_bytes": sum(c.raw_bytes for c in comps),
            "download_bytes": down_bytes, "download_raw_bytes": down_raw,
            "total_bytes": up_bytes + down_bytes,
            "upload_count": uploads, "download_count": down_count,
            "compression": codec.name,
            "down_compression": down_codec.name if down else "none", "simulated": True}
    if topo.is_pods:
        comm.update(simulated_pods_comm(
            topo, masks[start:], dense, intra_upload_bytes=up_bytes,
            intra_download_bytes=down_bytes if down else None,
            compression=codec.name, down_compression=comm["down_compression"]))
    return recorder.result(unravel(g, layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           resumed_from=resume_round, privacy=job.privacy_report(rounds))


# ---------------------------------------------------------------------------
# Buffered (FedBuff) rounds
# ---------------------------------------------------------------------------


def arrival_orders(masks: np.ndarray, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Buffered arrival permutations, one a round, padded with zeros past
    the active count, and the active counts: one ``default_rng(seed + 13)``
    drawn round by round, as the reference draws it."""
    rng = np.random.default_rng(seed + 13)
    rounds, num_sites = masks.shape
    order = np.zeros((rounds, num_sites), np.int32)
    n_act = np.zeros((rounds,), np.int32)
    for r in range(rounds):
        perm = rng.permutation(np.flatnonzero(masks[r])).astype(np.int32)
        order[r, :len(perm)] = perm
        n_act[r] = len(perm)
    return order, n_act


class Arrival(NamedTuple):
    """One arrival of the buffered schedule: ``site`` uploads a model
    trained on global version ``base`` (``tau`` versions old) and folds at
    ``weight`` (case weight times discount, fp32); ``admit`` false means it
    is too stale and resyncs to the current global; ``fire`` means the
    buffer becomes global ``version`` right after this fold."""
    site: int
    base: int
    tau: int
    admit: bool
    weight: np.float32
    fire: bool
    version: int


def buffered_schedule(masks: np.ndarray, seed: int, scheduler: BufferedScheduler,
                      case_weights: np.ndarray) -> Tuple[List[List[Arrival]], List[int]]:
    """The reference's buffered scan, its integer half replayed on the host:
    each round's arrivals (:class:`Arrival`) and the global version after
    each round.  Staleness, admission, the buffer count and the version
    depend on the masks and the arrival orders only, never on the data;
    the discount is the scan's fp32 ``(1 + tau) ** -alpha``."""
    order, n_act = arrival_orders(masks, seed)
    num_sites = masks.shape[1]
    base = np.zeros(num_sites, np.int64)
    version = count = 0
    cw = np.asarray(case_weights, np.float32)
    alpha = np.float32(scheduler.alpha)
    rounds, versions = [], []
    for r in range(masks.shape[0]):
        kmin = min(int(scheduler.buffer_k), max(int(n_act[r]), 1))
        arrivals, uploaded = [], []
        for j in range(int(n_act[r])):
            site = int(order[r, j])
            tau = version - int(base[site])
            admit = 0 <= tau <= scheduler.max_staleness
            disc = np.power(np.float32(1 + min(max(tau, 0), scheduler.max_staleness)), -alpha)
            fire = False
            if admit:
                count += 1
                uploaded.append(site)
                fire = count >= kmin
            if fire:
                version += 1
                count = 0
            arrivals.append(Arrival(site, int(base[site]), tau, admit,
                                    np.float32(cw[site] * disc), fire, version))
            if not admit:
                base[site] = version
        base[uploaded] = version
        rounds.append(arrivals)
        versions.append(version)
    return rounds, versions


def fold_arrival(acc: torch.Tensor, decoded: torch.Tensor, weight: np.float32) -> torch.Tensor:
    """One buffered arrival into the running sum, as the reference's scan
    folds it: ``acc + weight * decoded`` in fp32, a product then a sum."""
    return acc + decoded * torch.tensor(weight, device=acc.device)


def run_buffered(job, bundle, scheduler: BufferedScheduler, rounds: int, codec: Codec,
                 down_codec: Optional[Codec] = None, init_params=None,
                 on_round: Optional[Callable[[int], None]] = None,
                 resume_round: Optional[int] = None) -> JobResult:
    """``rounds`` buffered FedAvg rounds, dense, int8 or fp8 with a
    ``max_staleness`` inside the decode ring (the reference's buffered
    scan); arguments as :func:`run_sync`.

    Every round the sites train under ``individual``; then the active
    sites arrive in the round's seeded order (:func:`buffered_schedule`).
    An admitted arrival folds ``acc += w * decoded`` at its case weight
    times its staleness discount; a fire makes ``acc / sum w`` the new
    global version; a too-stale site resyncs to the current global; at
    the round's end every site that folded pulls the newest global.
    Version 0 is the case-weighted mean of the initial rows (``fedagg``).

    With a codec an arrival is its delta against the global of its version
    (a ring of the last ``KEEP_GLOBALS_DEFAULT`` versions) plus its
    error-feedback residual, quantized and dequantized on the reference's
    flat layout (the whole vector as one leaf in the reference's element
    order, ``align=1``): for int8 one ``quantize_int8`` and one
    ``dequantize_int8`` launch an arrival, for fp8 :func:`qdq_fp8`.
    ``comm`` (compressed only) counts that layout's bytes a fold and a dense
    download a fold; the history records each round's ``version``.

    Its carry (tag ``"buffered-scan"``) is the FL state, the global, the
    running sum and its weight and, with a codec, the version ring and the
    residuals; which arrival folds or fires is the host schedule's, a
    function of the masks."""
    ctx = job.context(bundle, strategy="individual")
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks, _ = _schedule(job, rounds, ctx.device)
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    engine = get_engine()
    dev = ctx.device
    cw = ctx.case_weights
    arrivals, versions = buffered_schedule(masks, job.seed, scheduler, cw.cpu().numpy())
    compress = codec.name != "none"
    error_feedback = bool(job.error_feedback)
    keep = KEEP_GLOBALS_DEFAULT
    s, n = state["params"].shape
    g = engine.reduce_flat(state["params"], cw / torch.sum(cw))
    acc = torch.zeros((n,), dtype=torch.float32, device=dev)
    accw = np.float32(0.0)
    if compress:
        plan = ChunkPlan.of(layout, codec.chunk, 1, dev, whole=True)
        ring = torch.zeros((keep, n), dtype=torch.float32, device=dev)
        ring[0].copy_(g)
        res = torch.zeros((s, n), dtype=torch.float32, device=dev)

    def carry():
        c = {"fl_state": _fl_tree(state), "global": g, "acc": acc,
             "accw": torch.tensor(accw)}
        if compress:
            c["ring"], c["residual"] = ring, res
        return c

    saved, _, start = _resume(job, recorder, "buffered-scan", resume_round, carry())
    if saved is not None:
        state = _restore_fl(state, saved["fl_state"], dev)
        g, acc = _dev(saved["global"], dev), _dev(saved["acc"], dev)
        accw = np.float32(saved["accw"])
        if compress:
            ring, res = _dev(saved["ring"], dev), _dev(saved["residual"], dev)

    def step(r, batches):
        nonlocal state, g, acc, accw
        state, metrics = fl_round(state, batches, F.make_round_inputs(ctx, masks[r]))
        p = state["params"]
        for a in arrivals[r]:
            if not a.admit:                  # too stale: resync, no contribution
                p[a.site].copy_(g)
                continue
            if compress:
                anchor = ring[a.base % keep]
                u = p[a.site] - anchor + res[a.site]
                deq = qdq(u, plan) if codec.name == "int8" else qdq_fp8(u, plan)
                if error_feedback:
                    res[a.site] = u - deq
                decoded = deq + anchor
            else:
                decoded = p[a.site]
            acc = fold_arrival(acc, decoded, a.weight)
            accw = np.float32(accw + a.weight)
            if a.fire:
                g = acc / torch.tensor(max(accw, np.float32(1e-12)), device=dev)
                if compress:
                    ring[a.version % keep].copy_(g)
                acc = torch.zeros_like(acc)
                accw = np.float32(0.0)
        for site in {a.site for a in arrivals[r] if a.admit}:
            p[site].copy_(g)                 # uploaders pull the newest global
        return metrics["loss"], {"version": versions[r]}

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round, start=start,
                global_fn=_reference_tree(lambda: engine.unflatten(g, layout)),
                save=_saver(job, recorder, "buffered-scan", carry))
    comm = None
    if compress:
        folds = sum(a.admit for rnd in arrivals[start:] for a in rnd)
        rows_f, c_f = chunk_geom(n, codec.chunk, 1)
        enc = rows_f * c_f + rows_f * 4          # the flat layout's payload bytes
        down_b = folds * 4 * n
        comm = {"upload_bytes": folds * enc, "upload_raw_bytes": folds * n * 4,
                "download_bytes": down_b, "total_bytes": folds * enc + down_b,
                "upload_count": folds, "download_count": folds,
                "compression": codec.name, "down_compression": "none",
                "simulated": True}
    return recorder.result(engine.unflatten(g, layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           resumed_from=resume_round, privacy=job.privacy_report(rounds))


def run_buffered_host(job, bundle, scheduler: BufferedScheduler, rounds: int,
                      codec: Codec, down_codec: Optional[Codec] = None, init_params=None,
                      on_round: Optional[Callable[[int], None]] = None,
                      resume_round: Optional[int] = None) -> JobResult:
    """Buffered FedAvg through the wire codec, the reference's host loop
    (``StackedTransport._execute_buffered``): the path of a codec whose
    ``max_staleness`` reaches past the decode ring, of the top-k codecs,
    and of ``round_engine="loop"``; arguments as :func:`run_sync`.

    Each round the active sites arrive in the order of one
    ``default_rng(seed + 13)``; each arrival is its site's
    :class:`~repro_torch.comms.compression.UploadCompressor` encode (the
    wire's per-leaf layout, delta against the global of its version, or
    dense when that version left the ring of ``KEEP_GLOBALS_DEFAULT``
    globals), decoded and folded into a
    :class:`~repro_torch.core.agg_engine.StreamingAccumulator` at its case
    weight times its discount (a dense job folds the row itself); ``ready``
    finalizes a new version.  ``comm`` (compressed only) is the
    compressors' counters and a dense download an upload.

    It saves the global on the checkpoint grid but no carry: a resume
    raises the reference's ``ValueError`` (its mid-round accumulator is
    not checkpointable)."""
    if resume_round is not None:
        raise ValueError(
            "the buffered host loop carries a mid-round accumulator "
            "that is not checkpointable; resume buffered jobs on "
            "the scan engine (round_engine='auto')")
    ctx = job.context(bundle, strategy="individual")
    state = _init_state(job, bundle, ctx, init_params)
    fl_round = F.build_fl_round(ctx)
    layout = state["layout"]
    masks, _ = _schedule(job, rounds, ctx.device)
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    engine = get_engine()
    s, n = state["params"].shape
    case_w = np.asarray(job.federation().case_weights())
    acc = StreamingAccumulator()
    order_rng = np.random.default_rng(job.seed + 13)
    version = 0
    base_version = np.zeros(s, np.int64)
    g = engine.reduce_flat(state["params"], ctx.case_weights / torch.sum(ctx.case_weights))
    compress = codec.name != "none"
    comps = [UploadCompressor(codec, job.error_feedback) for _ in range(s)]
    edge = comps[0].plan(unravel(g, layout))
    globals_by_version: "OrderedDict[int, torch.Tensor]" = OrderedDict({0: g})

    def step(r, batches):
        nonlocal state, g, version
        state, metrics = fl_round(state, batches, F.make_round_inputs(ctx, masks[r]))
        p = state["params"]
        active_idx = np.flatnonzero(masks[r])
        uploaded: List[int] = []
        for site in order_rng.permutation(active_idx):
            site = int(site)
            discount = scheduler.discount(version - int(base_version[site]))
            if discount is None:                     # too stale: resync only
                p[site].copy_(g)
                base_version[site] = version
                continue
            if compress:
                ref = globals_by_version.get(int(base_version[site]))
                enc, cmeta = comps[site].encode(unravel(p[site], layout),
                                                None if ref is None else unravel(ref, layout))
                decoded = edge.to_port(edge.decode(enc))
                if cmeta.get("delta"):
                    decoded = decoded + ref
            else:
                decoded = p[site].clone()
            acc.fold(unravel(decoded, layout), float(case_w[site]) * discount, owned=True)
            uploaded.append(site)
            if scheduler.ready(acc.count, len(active_idx)):
                g = ravel(acc.finalize())
                version += 1
                globals_by_version[version] = g
                while len(globals_by_version) > KEEP_GLOBALS_DEFAULT:
                    globals_by_version.popitem(last=False)
        for site in uploaded:                        # pull the newest global
            p[site].copy_(g)
            base_version[site] = version
        return metrics["loss"], {"version": version}

    _round_loop(job, bundle, ctx, masks, recorder, step, on_round,
                global_fn=_reference_tree(lambda: unravel(g, layout)))
    uploads = sum(c.encodes for c in comps)
    up_bytes = sum(c.encoded_bytes for c in comps)
    comm = None
    if compress:
        comm = {"upload_bytes": up_bytes, "upload_raw_bytes": sum(c.raw_bytes for c in comps),
                "download_bytes": uploads * 4 * n, "download_raw_bytes": uploads * 4 * n,
                "total_bytes": up_bytes + uploads * 4 * n,
                "upload_count": uploads, "download_count": uploads,
                "compression": codec.name, "down_compression": "none", "simulated": True}
    return recorder.result(engine.unflatten(g, layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           privacy=job.privacy_report(rounds))


# ---------------------------------------------------------------------------
# The sharded engine: the [S, ...] site state in blocks over devices
# ---------------------------------------------------------------------------


def pack_participants(participate: np.ndarray, weight: np.ndarray, pod_of: np.ndarray,
                      s_loc: int, num_devices: int):
    """Each round's participants in fixed per-device slots, the reference's
    ``_pack_participants``.  Sites live in contiguous blocks of ``s_loc``
    rows a device, so a participant never moves between devices.  Returns
    ``(lidx, valid, w, pod, gsite, k_cap)``, each array [rounds, D, k_cap]:
    a device's participants fill its first slots in site order; a padded
    slot has ``lidx == s_loc`` (past the block), weight 0, pod 0 and site
    0."""
    rounds = participate.shape[0]
    dev_of = np.arange(participate.shape[1]) // s_loc
    counts = [[int(np.sum(participate[r] & (dev_of == d)))
               for d in range(num_devices)] for r in range(rounds)]
    k_cap = max(1, max(max(c) for c in counts))
    lidx = np.full((rounds, num_devices, k_cap), s_loc, np.int32)
    valid = np.zeros((rounds, num_devices, k_cap), bool)
    w = np.zeros((rounds, num_devices, k_cap), np.float32)
    pod = np.zeros((rounds, num_devices, k_cap), np.int32)
    gsite = np.zeros((rounds, num_devices, k_cap), np.int32)
    for r in range(rounds):
        for d in range(num_devices):
            sites = np.flatnonzero(participate[r] & (dev_of == d))
            k = len(sites)
            lidx[r, d, :k] = sites - d * s_loc
            valid[r, d, :k] = True
            w[r, d, :k] = weight[r, sites]
            pod[r, d, :k] = pod_of[sites]
            gsite[r, d, :k] = sites
    return lidx, valid, w, pod, gsite, k_cap


def _refuse_sharded(job, scheduler, codec: Codec, down_codec: Optional[Codec],
                    resume_round: Optional[int]) -> None:
    """The reference's refusals of ``shard_sites=True``, in its order."""
    if isinstance(scheduler, BufferedScheduler):
        raise ValueError("shard_sites=True runs synchronous rounds only; "
                         "buffered-async scheduling needs the dense engine")
    if job.strategy not in ("fedavg", "fedprox"):
        raise ValueError("shard_sites=True supports the centrally-"
                         "aggregated strategies (fedavg/fedprox), not "
                         f"{job.strategy!r}")
    if codec.name not in ("none", "int8"):
        raise ValueError("shard_sites=True supports compression 'none' or "
                         f"'int8', not {codec.name!r}")
    if down_codec is not None and down_codec.name != "none":
        raise ValueError("shard_sites=True broadcasts the global through "
                         "the mesh collective, not the download codec; run "
                         "down_compression jobs on the dense engines")
    if job.device_data:
        raise ValueError("shard_sites=True generates only the sampled "
                         "rows' batches host-side; device_data=True would "
                         "regenerate all S on device")
    if job.dp is not None:
        raise ValueError("shard_sites=True does not thread DP-SGD noise "
                         "keys yet; run dp jobs on the dense engines")
    if resume_round is not None:
        raise ValueError("shard_sites=True does not checkpoint its "
                         "sharded carry; resume dense jobs instead")
    thinned = job.sampled or job.max_dropout or job.pod_dropout
    if thinned and job.dropout_scenario != "shutdown":
        raise ValueError(
            "shard_sites=True freezes non-participants entirely (they "
            "neither train nor receive the broadcast), which is the "
            "'shutdown' scenario; run sampled/dropout sharded jobs with "
            "dropout_scenario='shutdown'")


class _Block:
    """One device's block of ``s_loc`` site rows: the parameters, AdamW's
    moments and steps, under int8 the error-feedback residuals, and the
    replicated FedProx anchor and int8 reference."""

    def __init__(self, device: torch.device, one: torch.Tensor, s_loc: int, ctx,
                 prox: bool, quant: bool):
        self.device = device
        self.ctx = dataclasses.replace(ctx, device=device,
                                       case_weights=ctx.case_weights.to(device))
        self.fl_round = F.build_fl_round(self.ctx)
        one = one.to(device)
        self.params = one[None].expand(s_loc, -1).contiguous()
        self.opt = ctx.optimizer.init(self.params)
        self.opt["step"] = torch.zeros((s_loc,), dtype=torch.int32, device=device)
        self.anchor = one.clone() if prox else None
        self.ref = torch.zeros_like(one) if quant else None
        self.ef = torch.zeros_like(self.params) if quant else None


def execute_sharded(job, bundle, scheduler, rounds: int, codec: Codec,
                    down_codec: Optional[Codec] = None, init_params=None,
                    on_round: Optional[Callable[[int], None]] = None,
                    resume_round: Optional[int] = None,
                    devices: Optional[Sequence[torch.device]] = None) -> JobResult:
    """``shard_sites=True``: the stacked simulator with its [S, ...] site
    state in contiguous blocks of ``s_loc`` rows over ``devices`` (default:
    :func:`~repro_torch.launch.mesh.site_devices` of the job's device; a
    list is for tests that lay a CPU run over several blocks), and only
    each round's participants (``participate = sampled & available``)
    trained: the reference's ``execute_sharded``.

    A round on each device gathers the slab of its participants (at most
    ``k_cap`` rows, :func:`pack_participants`) and trains it under
    ``individual`` or ``fedprox-local`` (the anchor replicated on every
    device) on host batches built for those sites only; the padded slots
    hold zeros and train nothing.  Under int8 each upload is ``u = p - ref
    + ef`` through :func:`qdq` at the device's chunk alignment.  Each
    device folds its slab into one partial a pod (``fedagg`` with weights
    ``onehot * w * valid``); the partials and their weight totals are
    summed on the first device in device order, then the pod means and the
    inter-pod combine (``fedagg`` on [P, N]) follow the reference, ``1e-12``
    guards included.  The global (``ref`` plus it under int8) goes back to
    every device and is installed on the participants only, with their
    moments and residuals; the other rows stay as they were, bit for bit
    (the ``"shutdown"`` scenario, hence the reference's refusal of thinned
    ``"disconnect"`` jobs).  The history records ``participants`` and
    ``k_cap``, with NaN losses on the rows that did not train.  The result's
    global is ``ref`` under int8, else the Eq. 1 fold of every row at the
    case weights (``fedagg`` a device, summed in device order); ``comm``
    counts the reference's bytes and adds ``sharded``, ``devices`` and
    ``k_cap``."""
    _refuse_sharded(job, scheduler, codec, down_codec, resume_round)
    from repro_torch.launch.mesh import site_devices
    devs = list(devices) if devices is not None else site_devices(device=job.torch_device)
    num_devices = len(devs)
    num_sites = job.task.sites
    s_loc = -(-num_sites // num_devices)
    s_pad = s_loc * num_devices

    participate, wscale = job.participation(rounds)
    case_w = np.asarray(job.federation().case_weights(), np.float32)
    topo = job.topo
    if topo.is_pods:
        topo.validate(num_sites)
        num_pods = topo.num_pods
        pod_of = np.asarray(topo.pod_of(num_sites), np.int32)
        intra, inter = topo.intra, topo.inter
    else:
        # the flat fold is the 1-pod special case of the pod fold
        num_pods, pod_of = 1, np.zeros(num_sites, np.int32)
        intra, inter = "fedavg", "fedavg"
    base_w = np.ones(num_sites, np.float32) if intra == "uniform" else case_w
    lidx_a, valid_a, w_a, pod_a, gsite_a, k_cap = pack_participants(
        participate, base_w[None] * wscale, pod_of, s_loc, num_devices)

    quant = codec.name == "int8"
    prox = job.strategy == "fedprox"
    ctx = job.context(bundle, strategy="fedprox-local" if prox else "individual")
    engine = get_engine()
    error_feedback = bool(job.error_feedback)
    steps = job.local_steps
    one_tree = init_params if init_params is not None else bundle.init_fn(job.seed)
    flat_one, layout = engine.flatten(broadcast_to_sites(one_tree, 1))
    one = flat_one[0].contiguous()
    n = one.numel()
    blocks = [_Block(d, one, s_loc, ctx, prox, quant) for d in devs]
    plans = [ChunkPlan.of(layout, codec.chunk, codec.align(d), d) for d in devs] if quant else None
    lead = devs[0]
    recorder = job.recorder(rounds, num_sites)
    w_all = np.zeros(s_pad, np.float32)
    w_all[:num_sites] = case_w / case_w.sum()
    rnd = 0

    def global_flat() -> torch.Tensor:
        if quant:
            return blocks[0].ref
        total = None
        for d, b in enumerate(blocks):
            w = torch.from_numpy(w_all[d * s_loc:(d + 1) * s_loc]).to(b.device)
            part = engine.reduce_flat(b.params, w).to(lead)
            total = part if total is None else total + part
        return total

    def host_batches(r: int, d: int, k: int) -> Dict[str, torch.Tensor]:
        rows = []
        for site in gsite_a[r, d, :k]:
            ks = [bundle.sample(int(site), r * steps + j) for j in range(steps)]
            rows.append({key: np.stack([x[key] for x in ks]) for key in ks[0]})
        return {key: torch.from_numpy(np.stack([x[key] for x in rows])).to(devs[d])
                for key in rows[0]}

    for r in range(rounds):
        _sync(lead)
        t0 = time.perf_counter()
        counts = [int(valid_a[r, d].sum()) for d in range(num_devices)]
        batches = [host_batches(r, d, k) if k else None for d, k in enumerate(counts)]
        for d in devs:
            _sync(d)
        t1 = time.perf_counter()
        losses = np.full(s_pad, np.nan, np.float64)
        pod_num = pod_tot = None
        trained = []
        for d, (b, k) in enumerate(zip(blocks, counts)):
            idx = torch.from_numpy(lidx_a[r, d, :k].astype(np.int64)).to(b.device)
            slab = torch.zeros((k_cap, n), dtype=torch.float32, device=b.device)
            new_opt, u = None, None
            if k:
                st = {"params": b.params.index_select(0, idx), "layout": layout,
                      "opt": {key: v.index_select(0, idx) for key, v in b.opt.items()},
                      "strategy": {"global": b.anchor} if prox else {}, "round": rnd}
                st, metrics = b.fl_round(st, batches[d], {
                    "active": np.ones(k, bool), "partner": np.arange(k),
                    "is_receiver": np.zeros(k, bool)})
                new_opt = st["opt"]
                losses[d * s_loc + lidx_a[r, d, :k]] = metrics["loss"].cpu().numpy()
                if quant:
                    u = st["params"] - b.ref[None] + b.ef.index_select(0, idx)
                    slab[:k] = qdq(u, plans[d])
                else:
                    slab[:k] = st["params"]
            trained.append((idx, new_opt, u, slab[:k]))
            wk = torch.from_numpy(w_a[r, d] * valid_a[r, d]).to(b.device)
            pods = torch.from_numpy(pod_a[r, d]).to(b.device)
            onehot = (pods[None, :] == torch.arange(num_pods, device=b.device)[:, None]).float()
            wp = onehot * wk[None, :]                                   # [P, k_cap]
            part = torch.stack([engine.reduce_flat(slab, wp[p]) for p in range(num_pods)])
            tot = torch.sum(wp, dim=1)
            part, tot = part.to(lead), tot.to(lead)
            pod_num = part if pod_num is None else pod_num + part
            pod_tot = tot if pod_tot is None else pod_tot + tot
        pod_mean = pod_num / (pod_tot[:, None] + 1e-12)
        pod_w = (pod_tot > 0).float() if inter == "uniform" else pod_tot
        gflat = engine.reduce_flat(pod_mean, pod_w / (torch.sum(pod_w) + 1e-12))
        for b, (idx, new_opt, u, vals) in zip(blocks, trained):
            g = gflat.to(b.device)
            if quant:
                b.ref = b.ref + g
                g = b.ref
                if error_feedback and u is not None:
                    b.ef.index_copy_(0, idx, u - vals)
            if prox:
                b.anchor = g
            if new_opt is not None:
                b.params.index_copy_(0, idx, g[None].expand(idx.numel(), -1))
                for key, v in new_opt.items():
                    b.opt[key].index_copy_(0, idx, v)
        rnd += 1
        for d in devs:
            _sync(d)
        t2 = time.perf_counter()
        recorder.record(r, losses[:num_sites], participate[r],
                        global_fn=_reference_tree(lambda: engine.unflatten(global_flat(), layout)),
                        extra={"batch_s": t1 - t0, "step_s": t2 - t1, "wall_s": t2 - t0,
                               "participants": int(participate[r].sum()), "k_cap": k_cap})
        if on_round is not None:
            on_round(r)

    dense_nbytes = 4 * n
    uploads = int(participate.sum())
    if quant:
        enc = encoded_nbytes(layout.shapes, codec.chunk, codec.align(lead))
        comm = {"upload_bytes": uploads * enc,
                "upload_raw_bytes": uploads * dense_nbytes,
                "download_bytes": uploads * dense_nbytes,
                "total_bytes": uploads * (enc + dense_nbytes),
                "upload_count": uploads, "download_count": uploads,
                "compression": codec.name, "down_compression": "none",
                "simulated": True}
        if topo.is_pods:
            comm.update(simulated_pods_comm(topo, participate, dense_nbytes,
                                            intra_upload_bytes=uploads * enc,
                                            compression=codec.name))
    elif topo.is_pods:
        comm = simulated_pods_comm(topo, participate, dense_nbytes)
    else:
        comm = {"upload_bytes": uploads * dense_nbytes,
                "download_bytes": uploads * dense_nbytes,
                "total_bytes": 2 * uploads * dense_nbytes,
                "upload_count": uploads, "download_count": uploads,
                "compression": "none", "down_compression": "none",
                "simulated": True}
    comm.update({"sharded": True, "devices": num_devices, "k_cap": k_cap})

    def rows(get) -> torch.Tensor:
        parts = [get(b) for b in blocks]
        whole = parts[0] if len(parts) == 1 else torch.cat([p.to(lead) for p in parts])
        return whole[:num_sites]

    state = {"params": rows(lambda b: b.params), "layout": layout,
             "opt": {key: rows(lambda b, key=key: b.opt[key]) for key in blocks[0].opt},
             "strategy": {"global": blocks[0].anchor} if prox else {}, "round": rnd}
    return recorder.result(engine.unflatten(global_flat(), layout), transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm,
                           privacy=job.privacy_report(rounds))


# ---------------------------------------------------------------------------
# Routing: the reference's execute_stacked
# ---------------------------------------------------------------------------


RoundsFn = Callable[..., JobResult]


def engine_for(scheduler, codec: Codec, down_codec: Codec) -> Optional[RoundsFn]:
    """The rounds that run a stacked job on the device (the reference's
    ``execute_stacked``), or None where the reference's returns None and
    takes its host path: ``topk-sparse`` either way, a buffered top-k job,
    a buffered codec whose ``max_staleness`` reaches past the decode
    ring.  Each returned function takes ``(job, bundle, scheduler, rounds,
    codec, down_codec, init_params=, on_round=)``; ``down_codec`` is refused
    with a buffered scheduler before this."""
    down = down_codec.name != "none"
    if codec.name not in ("none", "int8", "fp8", "topk-fixed"):
        return None
    if down and down_codec.name not in ("int8", "fp8", "topk-fixed"):
        return None
    if isinstance(scheduler, BufferedScheduler):
        past_ring = codec.name != "none" and scheduler.max_staleness >= KEEP_GLOBALS_DEFAULT
        return None if past_ring or codec.name == "topk-fixed" else run_buffered
    if codec.name != "none" or down:
        return run_compressed
    return run_sync


def host_loop_for(scheduler, codec: Codec, down_codec: Codec) -> RoundsFn:
    """The host loop that runs a stacked job through the wire codec (the
    reference's retired per-round loops), as :func:`engine_for` returns."""
    if isinstance(scheduler, BufferedScheduler):
        return run_buffered_host
    if codec.name != "none" or down_codec.name != "none":
        return run_compressed_host
    return run_sync
