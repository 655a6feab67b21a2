"""Scheduler seam and round bookkeeping, ported from ``repro/core/session.py``.

A :class:`RoundScheduler` decides, for every upload an aggregation point
sees, whether it is admitted and at what weight (``discount``), and when
the buffered uploads become a new global (``ready``):

  * :class:`SyncScheduler`: the barrier round; only uploads for the round
    being collected are admitted, and it closes once every active site
    has reported.
  * :class:`BufferedScheduler`: FedBuff-style buffered rounds (Nguyen et
    al. 2022): a new global after ``buffer_k`` uploads, a late upload
    admitted at ``(1 + tau)^(-alpha)``, one staler than ``max_staleness``
    rejected (its site resyncs to the current global).

Both fold into the streaming accumulator, which normalizes by the folded
weight total.  :func:`availability_masks` replays the Algorithm-2 chain,
composed with the pod tier's under a pods topology, so every participant
agrees on the schedule without talking; :class:`JobResult` and
:class:`RoundRecorder` are the history and checkpoint bookkeeping every
transport shares, and :func:`check_engine_tag` / :func:`check_privacy_tag`
guard a stacked resume.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

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


@dataclass
class BufferedScheduler(RoundScheduler):
    """FedBuff-style K-of-S buffered aggregation with a staleness discount.

    ``buffer_k``      -- aggregate once this many uploads are buffered
                         (clamped to the active count).
    ``alpha``         -- staleness exponent: weight ~ (1 + tau)^(-alpha).
    ``max_staleness`` -- uploads more than this many versions old are
                         rejected; their site resyncs without contributing.
    """

    buffer_k: int = 2
    alpha: float = 0.5
    max_staleness: int = 4

    name = "buffered"

    def discount(self, staleness: int) -> Optional[float]:
        if staleness < 0 or staleness > self.max_staleness:
            return None
        return float((1.0 + staleness) ** (-self.alpha))

    def ready(self, buffered: int, expected: int) -> bool:
        return buffered >= min(self.buffer_k, max(expected, 1))

    def staleness_weights(self, staleness: Sequence[int]) -> np.ndarray:
        """Normalized buffer weights for uploads at the given staleness
        values (what the accumulator's normalization produces)."""
        weights = []
        for tau in staleness:
            w = self.discount(int(tau))
            if w is None:
                raise ValueError(f"staleness {tau} outside "
                                 f"[0, {self.max_staleness}]")
            weights.append(w)
        d = np.asarray(weights, dtype=np.float64)
        return (d / d.sum()).astype(np.float32)


_SCHEDULERS = {"sync": SyncScheduler, "buffered": BufferedScheduler}


def resolve_scheduler(spec: Union[str, RoundScheduler, None]) -> RoundScheduler:
    if spec is None:
        return SyncScheduler()
    if isinstance(spec, RoundScheduler):
        return spec
    try:
        return _SCHEDULERS[spec]()
    except KeyError:
        raise KeyError(f"unknown scheduler {spec!r}; known: {sorted(_SCHEDULERS)}")


def availability_masks(num_sites: int, max_dropout: int, seed: int,
                       rounds: int, topology=None, pod_dropout: int = 0) -> np.ndarray:
    """[rounds, num_sites] bool active masks from the Algorithm-2 chain;
    every replay with the same arguments gets the same schedule.

    With a pods topology and ``pod_dropout > 0`` a second chain runs at the
    pod tier (:func:`~repro_torch.core.topology.pod_availability_masks`) and
    the two compose by intersection.  On a round where the intersection is
    empty the pod tier's churn wins: the active pods' sites participate
    (an empty round would stall a barrier and zero the Eq. 1 weights)."""
    chain = SiteAvailability(num_sites, max_dropout, seed=seed)
    masks = np.stack([chain.step() for _ in range(rounds)])
    if topology is not None and pod_dropout:
        from repro_torch.core.topology import pod_availability_masks
        pod_masks = pod_availability_masks(topology, num_sites, pod_dropout, seed, rounds)
        combined = masks & pod_masks
        empty = ~combined.any(axis=1)
        combined[empty] = pod_masks[empty]
        masks = combined
    return masks


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
    # seconds spent before round 0's timed span (the kernels' builds and
    # loads on a card); 0.0 on the CPU
    compile_s: float = 0.0
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

    def to_dict(self) -> Dict[str, Any]:
        """The reference's summary: its keys, in its order."""
        return {"history": self.history, "final_loss": self.final_loss,
                "wall_s": self.wall_s, "compile_s": self.compile_s,
                "transport": self.transport,
                "scheduler": self.scheduler, "comm": self.comm,
                "resumed_from": self.resumed_from,
                "privacy": self.privacy,
                "rejected_uploads": self.rejected_uploads}


def check_engine_tag(meta: Dict[str, Any], engine: str):
    """Guard a ``driver_state`` resume: the checkpointed carry only fits
    the engine path that wrote it."""
    saved = meta.get("engine")
    if saved != engine:
        raise ValueError(
            f"driver_state checkpoint was written by engine {saved!r} but "
            f"this run resolves to {engine!r}; resume with the same "
            "round_engine / compression / scheduler settings")


def check_privacy_tag(meta: Dict[str, Any], dp_tag: Optional[List[Any]]):
    """Guard a resume across DP settings: the noise stream is a pure
    function of (seed, round, site, step) given the DP config, so
    re-entering with another clip, sigma or mode would splice two
    mechanisms into one trajectory (and void the accountant)."""
    saved = meta.get("dp")
    if saved is not None or dp_tag is not None:
        if list(saved or []) != list(dp_tag or []):
            raise ValueError(
                f"driver_state checkpoint was written with DP settings "
                f"{saved!r} but this run resolves to {dp_tag!r}; resume "
                "with the same dp_clip / dp_noise_multiplier / dp_mode "
                "/ seed")


class RoundRecorder:
    """Per-round history, progress printing and checkpointing."""

    def __init__(self, rounds: int, *, verbose: bool = False,
                 log_every: Optional[int] = None, num_sites: int = 1,
                 checkpoint_dir: Optional[Union[str, Path]] = None,
                 ckpt_every: int = 10):
        self.rounds = rounds
        self.verbose = verbose
        self.log_every = log_every or max(rounds // 10, 1)
        self.ckpt_every = ckpt_every
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
               global_fn=None, extra: Optional[Dict[str, Any]] = None):
        """Append round ``round_index``'s history; on the ``ckpt_every``
        grid, with a store, save ``global_fn()`` (tag ``"global"``)."""
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
        if (self.store and global_fn is not None
                and round_index % self.ckpt_every == 0):
            self.store.save("global", round_index, global_fn())

    def save_state(self, round_index: int, state_fn,
                   meta: Optional[Dict[str, Any]] = None):
        """Save ``state_fn()`` (called only on the grid) as the resumable
        engine state (tag ``"driver_state"``) on the ``ckpt_every`` grid;
        ``meta["engine"]`` guards a resume across engines."""
        if self.store and round_index % self.ckpt_every == 0:
            self.store.save("driver_state", round_index, state_fn(), meta=meta)

    def result(self, global_params, *, transport: str, scheduler: str,
               state=None, comm=None, compile_s: float = 0.0,
               resumed_from: Optional[int] = None, rejected_uploads: int = 0,
               privacy: Optional[Dict[str, Any]] = None) -> JobResult:
        return JobResult(history=self.history, global_params=global_params,
                         wall_s=time.time() - self._t0, transport=transport,
                         scheduler=scheduler, state=state, comm=comm, compile_s=compile_s,
                         resumed_from=resumed_from, rejected_uploads=rejected_uploads,
                         privacy=privacy)
