"""Sync rounds on the stacked transport, ported from ``repro/core/round_engine.py``.

The reference compiles chunks of rounds into one donated ``lax.scan``
(``_run_sync_scan``).  PyTorch runs eagerly, so the port's counterpart is
a plain round loop: host numpy batches for the round are moved to the
device, one ``fl_round`` runs, and the per-site losses come back.

Each round's history holds its own times: ``batch_s`` (host batch
generation and the copy to the device), ``step_s`` (the round on the
device) and ``wall_s`` (both: the end-to-end round).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import federation as F
from repro_torch.core.agg_engine import per_site_nbytes
from repro_torch.core.session import JobResult
from repro_torch.core.stacking import broadcast_to_sites
from repro_torch.tree import tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sync(job, bundle, scheduler, rounds: int, init_params=None,
             on_round: Optional[Callable[[int], None]] = None) -> JobResult:
    """``rounds`` sync FedAvg rounds of ``job``.  ``init_params`` (one
    unstacked tree) replaces the seeded initialization, e.g. to start from
    parameters converted from the reference.  ``on_round(r)`` is called
    after round ``r`` is recorded, outside its timed span (a profiler's
    ``step``, for one)."""
    ctx = job.context(bundle)
    params = init_params if init_params is not None else bundle.init_fn(job.seed)
    state = F.init_fl_state(ctx, tree_map(lambda t: t.to(ctx.device), params))
    fl_round = F.build_fl_round(ctx)
    masks = job.masks(rounds)
    recorder = job.recorder(rounds, ctx.fed.num_sites)
    for r in range(rounds):
        _sync(ctx.device)
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(ctx.device)
             for k, v in bundle.stacked(r, job.local_steps).items()}
        ri = F.make_round_inputs(ctx, active=masks[r])
        _sync(ctx.device)
        t1 = time.perf_counter()
        state, metrics = fl_round(state, b, ri)
        _sync(ctx.device)
        t2 = time.perf_counter()
        recorder.record(r, metrics["loss"].cpu().numpy(), masks[r],
                        extra={"batch_s": t1 - t0, "step_s": t2 - t1,
                               "wall_s": t2 - t0})
        if on_round is not None:
            on_round(r)
    global_params = F.global_model(state, ctx)
    nbytes = per_site_nbytes(broadcast_to_sites(global_params, 1))
    uploads = int(np.asarray(masks).sum())
    comm = {"upload_bytes": uploads * nbytes, "download_bytes": uploads * nbytes,
            "total_bytes": 2 * uploads * nbytes, "upload_count": uploads,
            "download_count": uploads, "compression": "none",
            "down_compression": "none", "simulated": True}
    return recorder.result(global_params, transport="stacked",
                           scheduler=scheduler.name, state=state, comm=comm)
