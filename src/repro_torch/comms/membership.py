"""Elastic membership: site leases, heartbeats, and late joiners, ported
from ``repro/comms/membership.py``.

FedKBP+ assumes a fixed site roster; a deployable coordinator cannot.
This module gives the aggregation point a lease table — a site is *live*
while its lease is fresh, and a site that goes silent for ``ttl``
seconds is expired and folds into the same Algorithm-2 dropout
accounting as a scheduled disconnect: the round's barrier expectation
shrinks to the live membership (never below one survivor), the
remaining uploads renormalize through the Eq. 1 weighted fold, and the
round finalizes instead of deadlocking.

The client half is :class:`HeartbeatClient`: a daemon thread that joins
the lease table, renews on a ``ttl/3`` cadence, and (on graceful stop)
leaves explicitly so the barrier does not have to wait out the ttl.
The join reply doubles as the late-joiner bootstrap: it carries the
server's current round and a dense copy of the current global, so a
site admitted mid-job starts from the live model (the same dense-resend
path quantized uploads use when their decode reference is evicted).

Server integration lives in ``repro_torch.comms.coordinator`` — the registry
itself is transport-free and lock-free (callers hold the server lock).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class LeaseRegistry:
    """Lease table for elastic membership at an aggregation point.

    Not thread-safe by itself — the owning server calls every method
    under its own condition lock, so expiry decisions and barrier
    re-checks are atomic with the fold state.
    """

    def __init__(self, ttl: float):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be positive, got {ttl}")
        self.ttl = float(ttl)
        self._deadline: Dict[int, float] = {}
        #: sites ever admitted — distinguishes "nobody uses leases" from
        #: "everyone expired" when computing barrier expectations
        self.ever: int = 0
        #: (round, site) log of expiries, for diagnostics/tests
        self.expired_log: List[Any] = []

    def join(self, site: int) -> None:
        """Admit (or re-admit) a site; also the renew operation."""
        if site not in self._deadline:
            self.ever += 1
        self._deadline[site] = time.monotonic() + self.ttl

    renew = join

    def leave(self, site: int) -> None:
        self._deadline.pop(site, None)

    def live(self) -> List[int]:
        now = time.monotonic()
        return sorted(s for s, d in self._deadline.items() if d > now)

    def live_count(self) -> int:
        return len(self.live())

    def is_live(self, site: int) -> bool:
        d = self._deadline.get(site)
        return d is not None and d > time.monotonic()

    def expire(self) -> List[int]:
        """Drop every overdue lease; returns the sites expired now."""
        now = time.monotonic()
        dead = sorted(s for s, d in self._deadline.items() if d <= now)
        for s in dead:
            del self._deadline[s]
        return dead

    def expected(self, scheduled: int) -> int:
        """Barrier expectation for a round that *scheduled* ``scheduled``
        active sites (from the Algorithm-2 masks).  Elastic rule: never
        wait for more sites than are actually live, never shrink below
        one survivor.  Before any site has joined the table the
        scheduled count stands (leases not in use on that path)."""
        if self.ever == 0:
            return scheduled
        return max(1, min(int(scheduled), self.live_count()))


class HeartbeatClient:
    """Daemon-thread lease renewal for one site against one server.

    ``request(kind, meta)`` is the transport hook (a bound
    ``Peer``/``Channel`` request); the client stays transport-agnostic.
    """

    def __init__(self, site_id: int, request: Callable[..., Any],
                 ttl: float, identity: Optional[str] = None):
        self.site_id = site_id
        self.request = request
        self.ttl = float(ttl)
        self.identity = identity or f"site:{site_id}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self.join_meta: Dict[str, Any] = {}
        self.bootstrap: Any = None

    def start(self) -> "HeartbeatClient":
        """Join the lease table (blocking), then renew in the background.
        The join reply's round + global are kept for late-joiner
        bootstrap (``join_meta`` / ``bootstrap``)."""
        _, meta, tree = self.request(
            "join", {"site": self.site_id, "peer": self.identity})
        self.join_meta = meta
        self.bootstrap = tree
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.wait(self.ttl / 3.0):
            try:
                self.request("heartbeat", {"site": self.site_id})
            except Exception:  # noqa: BLE001 — channel retries already ran
                # a dead server ends the job through the main rpc path;
                # the heartbeat thread must not crash the site process
                pass

    def stop(self, leave: bool = True):
        """Stop renewing; with ``leave`` (graceful shutdown) also drop
        the lease immediately so barriers do not wait out the ttl."""
        self._stop.set()
        if leave:
            try:
                self.request("leave", {"site": self.site_id})
            except Exception:  # noqa: BLE001
                pass
        self._thread.join(timeout=2)
