"""Scheduler seam and round bookkeeping, ported from ``repro/core/session.py``.

Ported: the sync barrier scheduler, the deterministic Algorithm-2 mask
replay (flat topology), the job result and a recorder that keeps the
per-round history.  Buffered scheduling, pod-tier churn and checkpoints
are not ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch import NotPorted
from repro_torch.core.dropout import SiteAvailability


@dataclass
class SyncScheduler:
    """Barrier semantics: current-round uploads only, wait for all.  The
    port's round loop is that barrier, so the scheduler only names it;
    the reference's ``discount``/``ready`` come with buffered scheduling."""

    name = "sync"


def scheduler_name(spec: Union[str, SyncScheduler, None]) -> str:
    """The name of a scheduler spec, unresolved: buffered rounds are not
    ported, but the guards that refuse their compositions are."""
    if spec is None or isinstance(spec, SyncScheduler):
        return "sync"
    if spec in ("sync", "buffered"):
        return spec
    raise KeyError(f"unknown scheduler {spec!r}; known: ['buffered', 'sync']")


def resolve_scheduler(spec: Union[str, SyncScheduler, None]) -> SyncScheduler:
    if spec is None or spec == "sync":
        return SyncScheduler()
    if isinstance(spec, SyncScheduler):
        return spec
    raise NotPorted("scheduler", f"{spec!r}", "'sync'")


def availability_masks(num_sites: int, max_dropout: int, seed: int,
                       rounds: int) -> np.ndarray:
    """[rounds, num_sites] bool active masks from the Algorithm-2 chain;
    every replay with the same arguments gets the same schedule."""
    chain = SiteAvailability(num_sites, max_dropout, seed=seed)
    return np.stack([chain.step() for _ in range(rounds)])


@dataclass
class JobResult:
    """What ``FederatedJob.run`` hands back."""

    history: List[Dict[str, Any]]
    global_params: Any                      # the aggregated global model
    wall_s: float
    transport: str
    scheduler: str
    state: Optional[Dict[str, Any]] = None  # the round loop's state
    # simulated upload/download bytes (one fp32 model per active site per
    # round, each direction)
    comm: Optional[Dict[str, Any]] = None

    @property
    def losses(self) -> List[float]:
        return [h["loss"] for h in self.history]

    @property
    def final_loss(self) -> float:
        if not self.history:
            return float("nan")
        return self.history[-1]["loss"]


class RoundRecorder:
    """Per-round history and progress printing."""

    def __init__(self, rounds: int, *, verbose: bool = False,
                 log_every: Optional[int] = None, num_sites: int = 1):
        self.rounds = rounds
        self.verbose = verbose
        self.log_every = log_every or max(rounds // 10, 1)
        self.num_sites = num_sites
        self.history: List[Dict[str, Any]] = []
        self._t0 = time.time()
        self._t_last = self._t0

    def record(self, round_index: int, per_site_loss, active,
               extra: Optional[Dict[str, Any]] = None):
        now = time.time()
        per_site = np.asarray(per_site_loss, dtype=np.float64).reshape(-1)
        loss = float(np.nanmean(per_site))
        n_active = int(np.sum(active))
        rec = {"round": round_index, "loss": loss, "active": n_active,
               "per_site_loss": per_site.tolist(),
               "wall_s": now - self._t_last, **(extra or {})}
        self.history.append(rec)
        self._t_last = now
        if self.verbose and (round_index % self.log_every == 0
                             or round_index == self.rounds - 1):
            print(f"round {round_index:4d} loss {loss:.4f} "
                  f"active {n_active}/{self.num_sites}")

    def result(self, global_params, *, transport: str, scheduler: str,
               state=None, comm=None) -> JobResult:
        return JobResult(history=self.history, global_params=global_params,
                         wall_s=time.time() - self._t0, transport=transport,
                         scheduler=scheduler, state=state, comm=comm)
