"""Scheduler seam and round bookkeeping, ported from ``repro/core/session.py``.

Ported: the scheduler seam (a :class:`RoundScheduler` decides whether
an upload is admitted and at what weight, and when the buffered uploads
become a new global) with the sync barrier scheduler, the deterministic
Algorithm-2 mask replay (flat topology), the job result (with the socket
transports' ``comm`` split) and a recorder that keeps the per-round
history and, with a ``checkpoint_dir``, a checkpoint store.  Buffered
scheduling and pod-tier churn are not ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch import NotPorted
from repro_torch.core.dropout import SiteAvailability


class RoundScheduler:
    """When do buffered uploads become a new global model, and at what
    weight does each upload enter the buffer?"""

    name: str = "base"

    def discount(self, staleness: int) -> Optional[float]:
        """Weight multiplier for an upload ``staleness`` global versions
        old (0 = trained on the current global); ``None`` rejects it."""
        raise NotImplementedError

    def ready(self, buffered: int, expected: int) -> bool:
        """True once ``buffered`` folded uploads should be finalized
        (``expected`` = the currently active sites)."""
        raise NotImplementedError


@dataclass
class SyncScheduler(RoundScheduler):
    """Barrier semantics: current-round uploads only, wait for all.

    ``round_deadline_s`` bounds how long a socket server's barrier waits on
    stragglers once the round's first upload has folded; ``None`` keeps
    the strict barrier.  The stacked round loop is a barrier by
    construction and ignores it."""

    round_deadline_s: Optional[float] = None

    name = "sync"

    def discount(self, staleness: int) -> Optional[float]:
        return 1.0 if staleness == 0 else None

    def ready(self, buffered: int, expected: int) -> bool:
        return buffered >= expected


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
    # upload/download bytes: simulated payload bytes on the stacked
    # transport; on the socket transports the server's framed bytes, with
    # the payload split (site_payload_bytes, download_payload_bytes)
    comm: Optional[Dict[str, Any]] = None
    # the checkpoint round a resumed run re-entered from (None: round 0)
    resumed_from: Optional[int] = None
    # uploads the socket server rejected (non-finite, norm outliers,
    # undecodable); 0 on the stacked transport
    rejected_uploads: int = 0
    # the privacy mechanisms' settings (FederatedJob.privacy_report); None
    # when none is on
    privacy: Optional[Dict[str, Any]] = None

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
                 log_every: Optional[int] = None, num_sites: int = 1,
                 checkpoint_dir: Optional[Union[str, Path]] = None):
        self.rounds = rounds
        self.verbose = verbose
        self.log_every = log_every or max(rounds // 10, 1)
        self.num_sites = num_sites
        self.history: List[Dict[str, Any]] = []
        self.store = None
        if checkpoint_dir:
            from repro_torch.checkpoint import CheckpointStore
            self.store = CheckpointStore(Path(checkpoint_dir))
        self._t0 = time.time()
        self._t_last = self._t0

    @property
    def elapsed(self) -> float:
        """Seconds since the recorder (and so the run) started."""
        return time.time() - self._t0

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
               state=None, comm=None, resumed_from: Optional[int] = None,
               rejected_uploads: int = 0,
               privacy: Optional[Dict[str, Any]] = None) -> JobResult:
        return JobResult(history=self.history, global_params=global_params,
                         wall_s=time.time() - self._t0, transport=transport,
                         scheduler=scheduler, state=state, comm=comm,
                         resumed_from=resumed_from, rejected_uploads=rejected_uploads,
                         privacy=privacy)
