"""The aggregation server of centralized FL (paper Figs 3 and 4, Algorithm 1),
ported from ``repro/comms/coordinator.py``: its sync branch.

``AggregationServer`` folds each site's upload into a streaming Eq. 1
accumulator as it arrives (one fp32 model of memory, not one per site),
normalizes once every expected site has reported, and hands the global
back on download.  The reference's server is numpy on the host; the
port's runs on the job's device, because that is where the message
decode runs: a received upload becomes a device tree by one copy of the
frame's payload and ONE ``dequantize_int8`` launch for all its int8
leaves (:func:`repro_torch.comms.compression.decode_upload`), then ``+
reference`` for a delta, the sanitation checks and the fold, all on the
device.  The server works in the wire's layout throughout (the
reference's: conv weights DHWIO) and never needs the port's.

Ported: sync barrier rounds with Algorithm-2 dropout, the robust rules
(a per-round row buffer for the rank rules, ``normclip`` before the fold),
upload sanitation (``max_upload_norm``, non-finite uploads), the round
deadline, downlink compression with per-site held references on the
device, leases and late joiners, and server-side checkpoints.  Buffered
scheduling, secure aggregation and the ``CoordinationServer`` of
decentralized FL are not.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Set

import torch

from repro_torch import NotPorted
from repro_torch.comms import compression
from repro_torch.comms.codec import encode_message
from repro_torch.comms.membership import LeaseRegistry
from repro_torch.comms.transport import Server, WireConfig, WireStats
from repro_torch.core.agg_engine import (StreamingAccumulator, clip_tree_norm,
                                         parse_aggregator, robust_combine_trees,
                                         tree_all_finite, tree_l2_norm, tree_layout)
from repro_torch.core.session import RoundScheduler, SyncScheduler

# what a malformed payload raises while it decodes (a device fault is none
# of these, and reaches the site as an error reply, never a rejection)
_MALFORMED = (ValueError, TypeError, KeyError, IndexError)


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("AggregationServer runs on CUDA by default, and CUDA "
                           "is not available here; pass device='cpu'")
    return dev


class AggregationServer:
    """Centralized FL server (FedAvg upload -> aggregate -> broadcast).

    Uploads stream through a :class:`StreamingAccumulator` on ``device``.
    Duplicate uploads for a round are acknowledged but not folded twice.
    A download that outwaits ``download_timeout`` gets an ``error`` reply.
    Quantized uploads decode before the fold; a ``delta`` upload is
    rebuilt against the global the site last pulled (``base_round``, from
    a bounded history of recent globals), or, under downlink compression,
    against the server's held copy of that site's install.

    The :class:`SyncScheduler` keeps barrier semantics: a straggler's
    upload for an earlier round is acked ``{"stale": true}`` and not
    folded; a site that sat out rounds and uploads ahead waits for the
    server to catch up.  ``device`` is where the server decodes, folds and
    keeps its globals: ``None`` means CUDA."""

    def __init__(self, host: str, port: int, num_sites: int,
                 case_weights: Optional[List[float]] = None,
                 download_timeout: float = 60.0,
                 scheduler: Optional[RoundScheduler] = None,
                 keep_globals: int = compression.KEEP_GLOBALS_DEFAULT,
                 wire: Optional[WireConfig] = None,
                 lease_ttl: Optional[float] = None,
                 initial_round: int = 0, initial_global: Any = None,
                 ckpt_store=None, ckpt_every: int = 10,
                 secure_agg=None, aggregator=None,
                 max_upload_norm: Optional[float] = None,
                 down_compression=None, initial_down=None, device=None):
        self.device = _device(device)
        self.num_sites = num_sites
        self.aggregator = parse_aggregator(aggregator)
        if secure_agg is not None:
            raise NotPorted("secure_agg", "an AggregationServer with secure_agg",
                            "plaintext uploads")
        scheduler = scheduler or SyncScheduler()
        if not isinstance(scheduler, SyncScheduler):
            raise NotPorted("scheduler", repr(scheduler), "'sync'")
        self._rows: Dict[int, Any] = {}
        self.max_upload_norm = max_upload_norm
        self._rejected: Set[int] = set()
        self.rejected_uploads = 0
        self.weights = {i: (case_weights[i] if case_weights else 1.0)
                        for i in range(num_sites)}
        self.download_timeout = download_timeout
        self.scheduler = scheduler
        self.keep_globals = keep_globals
        self.stats = WireStats()
        self._lock = threading.Condition()
        self._acc = StreamingAccumulator()
        self._folded: Set[int] = set()
        self._round = int(initial_round)
        self._global: Any = (None if initial_global is None
                             else compression.decode_tree(initial_global, device=self.device))
        self._host: Any = None                  # (round, host copy of the global)
        self._plan: Optional[compression.WirePlan] = None
        self._globals: Dict[int, Any] = {}
        if self._global is not None:
            self._globals[self._round] = self._global
        down_codec = compression.resolve_codec(down_compression, "down_compression")
        self._down = (compression.DownlinkCompressor(down_codec)
                      if down_codec.name != "none" else None)
        if self._down is not None and initial_down:
            for sid, (held, held_round) in initial_down.items():
                self._down.restore(int(sid), held, held_round, device=self.device)
        self._ckpt_store = ckpt_store
        self._ckpt_every = int(ckpt_every)
        self.lease_ttl = lease_ttl
        self.registry = LeaseRegistry(lease_ttl) if lease_ttl else None
        self._last_scheduled = num_sites
        self._reaper_stop = threading.Event()
        self._reaper: Optional[threading.Thread] = None
        if self.registry is not None:
            self._reaper = threading.Thread(target=self._reap, daemon=True)
            self._reaper.start()
        self.round_deadline_s = scheduler.round_deadline_s
        self._first_fold_t: Optional[float] = None
        self._deadline_stop = threading.Event()
        self._deadline_thread: Optional[threading.Thread] = None
        if self.round_deadline_s:
            self._deadline_thread = threading.Thread(target=self._deadline_watch,
                                                     daemon=True)
            self._deadline_thread.start()
        # read-only decode: the arrays stay views into the frame, whose
        # payload goes to the device in one copy
        self.server = Server(host, port, self._handle, stats=self.stats, wire=wire).start()
        self.addr = self.server.addr

    @property
    def down_counters(self) -> Optional[dict]:
        """Payload-level downlink codec counters, or None when downloads
        ride dense."""
        if self._down is None:
            return None
        return {"raw": self._down.raw_bytes, "encoded": self._down.encoded_bytes,
                "encodes": self._down.encodes, "dense_sends": self._down.dense_sends}

    def _host_global(self):
        """Lock held.  The current global on the host, copied once a round."""
        if self._global is None:
            return None
        if self._host is None or self._host[0] != self._round:
            self._host = (self._round, compression.host_tree(self._global))
        return self._host[1]

    def _discount(self, upload_round: int) -> Optional[float]:
        """Lock held.  The round being collected is ``self._round + 1``."""
        return self.scheduler.discount(self._round + 1 - upload_round)

    def _wait_for_upload_round(self, upload_round: int) -> None:
        """Lock held.  A site that sat out rounds uploads ahead of the
        server; it waits (up to ``download_timeout``) for the server to
        catch up rather than being dropped as stale."""
        self._lock.wait_for(lambda: upload_round <= self._round + 1,
                            timeout=self.download_timeout)

    def _finalize_buffer(self):
        """Lock held.  The round's global: the rank rule over the row
        buffer, or the normalized streaming sum."""
        if self.aggregator.rank_based:
            rows = [self._rows[s] for s in sorted(self._rows)]
            self._rows = {}
            return robust_combine_trees(rows, self.aggregator)
        return self._acc.finalize()

    def _on_ready(self):
        """Lock held.  Finalize into a new global and advance the round."""
        tree = self._finalize_buffer()
        if tree is not None:
            self._global = tree
        # (None when every upload of the round was rejected: the current
        # global is re-published and the round advances)
        self._folded = set()
        self._rejected = set()
        self._first_fold_t = None
        self._round += 1
        self._globals[self._round] = self._global
        for old in [k for k in self._globals if k <= self._round - self.keep_globals]:
            del self._globals[old]
        if self._down is not None:
            self._down.evict_stale(self._round, self.keep_globals)
        self._checkpoint_global()
        self._lock.notify_all()

    def _checkpoint_global(self):
        """Lock held.  Server round r is the global after loop round r-1,
        saved on the ``ckpt_every`` grid with the per-site held references."""
        round_index = self._round - 1
        if self._ckpt_store is not None and round_index % self._ckpt_every == 0:
            self._ckpt_store.save("global", round_index, self._global,
                                  meta={"server_round": self._round})
            if self._down is not None:
                for sid in self._down.held_sites():
                    held, held_round = self._down.held_state(sid)
                    self._ckpt_store.save(f"downref{sid}", round_index, held,
                                          meta={"held_round": int(held_round)})

    # -- elastic membership -------------------------------------------------

    def _expected(self, scheduled: int) -> int:
        if self.registry is None:
            return int(scheduled)
        return self.registry.expected(int(scheduled))

    def _barrier_expected(self) -> int:
        """Lock held.  The scheduled count, shrunk to the live leases, minus
        the sites whose upload this round was rejected."""
        return max(self._expected(self._last_scheduled) - len(self._rejected), 0)

    def _maybe_finalize(self):
        """Lock held.  Re-check the barrier after membership shrank."""
        if self._folded and self.scheduler.ready(len(self._folded), self._barrier_expected()):
            self._on_ready()

    def _reap(self):
        period = max(self.registry.ttl / 4.0, 0.01)
        while not self._reaper_stop.wait(period):
            with self._lock:
                dead = self.registry.expire()
                if dead:
                    self.registry.expired_log.extend((self._round + 1, s) for s in dead)
                    self._maybe_finalize()
                    self._lock.notify_all()

    def _deadline_watch(self):
        period = max(float(self.round_deadline_s) / 4.0, 0.01)
        while not self._deadline_stop.wait(period):
            with self._lock:
                if (self._folded and self._first_fold_t is not None
                        and time.time() - self._first_fold_t >= self.round_deadline_s):
                    self._on_ready()
                    self._lock.notify_all()

    def _reject_upload(self, site: int, reason: str) -> bytes:
        """Record a sanitation rejection and re-check the barrier."""
        with self._lock:
            if site not in self._folded and site not in self._rejected:
                self._rejected.add(site)
                self.rejected_uploads += 1
                if self.scheduler.ready(len(self._folded), self._barrier_expected()):
                    self._on_ready()
                self._lock.notify_all()
            rnd = self._round
        return encode_message("ack", {"round": rnd, "stale": False, "rejected": True,
                                      "reason": reason}, None)

    def _stale(self, meta) -> Optional[bytes]:
        """Take the lock, wait for an early upload's round, and return the
        stale ack if the upload is not for the round being collected."""
        with self._lock:
            upload_round = int(meta.get("round", self._round + 1))
            self._wait_for_upload_round(upload_round)
            if self._discount(upload_round) is None:
                return encode_message("ack", {"round": self._round, "stale": True}, None)
        return None

    def _wire_plan(self, tree) -> compression.WirePlan:
        """The model's wire plan on the server's device: the global's layout
        where there is a global, else the first upload's (the reference's
        server takes the model's structure from its first fold too)."""
        if self._plan is None:
            model = self._global if self._global is not None else tree
            self._plan = compression.WirePlan.of(
                tree_layout(model), 1024, compression.align_for(self.device), self.device,
                port=False)
        return self._plan

    def _upload(self, meta, tree) -> bytes:
        site = int(meta["site"])
        if meta.get("masked"):
            return encode_message("error", {"message": "masked upload to a server "
                                                       "without secure aggregation "
                                                       "configured"}, None)
        # decode outside the lock: only the staleness check and the
        # reference's snapshot need it; staleness is checked again before
        # the fold, in case the round advanced meanwhile
        with self._lock:
            upload_round = int(meta.get("round", self._round + 1))
            self._wait_for_upload_round(upload_round)
            if self._discount(upload_round) is None:
                return encode_message("ack", {"round": self._round, "stale": True}, None)
            reference = None
            if meta.get("delta"):
                base_round = int(meta.get("base_round", 0))
                if self._down is not None:
                    # under downlink compression the site anchored its delta to
                    # its decoded install, bit-equal to the server's held copy
                    st = self._down.held_state(site)
                    if st is not None and st[1] == base_round:
                        reference = st[0]
                if reference is None:
                    reference = self._globals.get(base_round)
        if meta.get("delta") and reference is None:
            # the reference global was evicted: the site resyncs
            return encode_message("ack", {"round": self._round, "stale": True}, None)
        try:
            tree = compression.decode_upload(tree, meta, reference, plan=self._wire_plan(tree))
        except _MALFORMED as exc:
            return self._reject_upload(site, f"decode: {exc}")
        stale = self._stale(meta)
        if stale is not None:
            return stale
        if not tree_all_finite(tree):
            return self._reject_upload(site, "non_finite")
        if self.max_upload_norm is not None and tree_l2_norm(tree) > self.max_upload_norm:
            return self._reject_upload(site, "norm_outlier")
        if self.aggregator.name == "normclip":
            tree = clip_tree_norm(tree, self.aggregator.c)
        with self._lock:
            upload_round = int(meta.get("round", self._round + 1))
            self._wait_for_upload_round(upload_round)
            discount = self._discount(upload_round)
            if discount is None:
                return encode_message("ack", {"round": self._round, "stale": True}, None)
            if site not in self._folded:
                if self.aggregator.rank_based:
                    self._rows[site] = tree
                else:
                    w = float(meta.get("weight", self.weights[site]))
                    # the decoded upload is this handler's own buffer
                    self._acc.fold(tree, w * discount, owned=True)
                self._folded.add(site)
                if self._first_fold_t is None:
                    self._first_fold_t = time.time()
            if self.registry is not None:            # an upload is a renewal
                self.registry.renew(site)
            self._last_scheduled = int(meta.get("active_sites", self.num_sites))
            if self.scheduler.ready(len(self._folded), self._barrier_expected()):
                self._on_ready()
            return encode_message("ack", {"round": self._round, "stale": False}, None)

    def _handle(self, kind, meta, tree):
        if kind == "upload":
            return self._upload(meta, tree)
        if kind == "download":
            want_round = int(meta["round"])
            with self._lock:
                done = self._lock.wait_for(lambda: self._round >= want_round,
                                           timeout=self.download_timeout)
                if not done:
                    return encode_message(
                        "error",
                        {"message": f"timeout: round {want_round} not complete "
                                    f"(server at round {self._round}, "
                                    f"{len(self._folded)} uploads folded)"}, None)
                if self._down is not None and meta.get("down"):
                    payload, dmeta = self._down.encode(
                        int(meta["site"]), self._global, self._round,
                        acked_round=meta.get("acked_round"), host_tree=self._host_global())
                    return encode_message("global", {"round": self._round, **dmeta}, payload)
                return encode_message("global", {"round": self._round}, self._host_global())
        if kind == "status":
            return encode_message("status", {"round": self._round,
                                             "pending": len(self._folded),
                                             "rejected_uploads": self.rejected_uploads}, None)
        if kind == "join":
            # lease admission; the reply is also the late joiner's bootstrap:
            # the current round and a dense copy of the current global
            with self._lock:
                if self.registry is not None:
                    self.registry.join(int(meta["site"]))
                return encode_message("joined", {"round": self._round,
                                                 "ttl": float(self.lease_ttl or 0.0)},
                                      self._host_global())
        if kind == "heartbeat":
            with self._lock:
                if self.registry is not None:
                    self.registry.renew(int(meta["site"]))
                return encode_message("ack", {"round": self._round}, None)
        if kind == "leave":
            with self._lock:
                if self.registry is not None:
                    self.registry.leave(int(meta["site"]))
                    self._maybe_finalize()
                    self._lock.notify_all()
                return encode_message("ack", {"round": self._round}, None)
        raise ValueError(f"unknown rpc {kind!r}")

    def stop(self):
        self._reaper_stop.set()
        self._deadline_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=2)
        if self._deadline_thread is not None:
            self._deadline_thread.join(timeout=2)
        self.server.stop()
