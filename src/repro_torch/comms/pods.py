"""Two-tier pods on the socket transports, ported from ``repro/comms/pods.py``.

A pods :class:`~repro_torch.core.topology.Topology` on ``transport="thread"
| "tcp"`` builds this server stack instead of the flat star:

    sites --upload-->  PodAggregationServer (one a pod)
                            | pod_partial            ^ install_global
                            v                        |
                       pod leader --upload-->  root AggregationServer
                                  <--download--      (cross-pod combine)

Each pod's server folds its sites' uploads as the flat server does, but a
complete buffer becomes a *partial* (the pod's case-weighted mean, with
its folded weight) instead of a new round.  The pod's leader, a relay
thread of the job's process (the hospital group's hub), pulls the partial,
re-uploads it to the root over the ordinary wire (its weight in the
upload's meta), downloads the combined global and installs it into its
pod's server, which is when the pod's sites see the round advance.  Sites
run the unchanged site script against their pod server's address.

The scheduler seam is per tier: the pod servers take the topology's
``intra_scheduler`` and the root its ``inter_scheduler``, so a sync pod
under a buffered root, and the reverse, both run.  Secure aggregation
runs at both tiers: sites mask against their pod's scheduled members, the
leaders mask partials against the round's active pods.  With an upload
codec a leader's partial rides its own compressor (a delta against the
last root global it pulled); with a download codec both install hops are
compressed.

Every server runs on the job's device; a leader decodes and encodes
there.  The pod servers count the intra-pod bytes, the root the cross-pod
bytes (:meth:`PodTransport.comm`).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.comms import compression
from repro_torch.comms.codec import encode_message
from repro_torch.comms.coordinator import AggregationServer
from repro_torch.comms.transport import WireConfig, make_channel
from repro_torch.core.session import BufferedScheduler, RoundScheduler
from repro_torch.core.topology import Topology, active_pod_counts


class PodAggregationServer(AggregationServer):
    """A pod's aggregation point.

    Uploads fold as at the flat server (the same staleness, compression
    and duplicate rules), but a complete buffer finalizes into a partial
    for the pod's leader; the round (what site downloads wait on) advances
    only when the leader installs the root's global.  Two more rpcs:

      ``pod_partial``    -- leader: wait until partial ``round`` exists and
                            return it with its folded weight;
      ``install_global`` -- leader: set the round's global (also a delta
                            decode reference) and wake the sites' downloads.
    """

    def __init__(self, *args, pod_id: int = 0, **kw):
        self.pod_id = pod_id
        self._partial: Any = None
        self._partial_weight = 0.0
        self._partial_round = 0
        super().__init__(*args, **kw)

    def _on_ready(self):                     # lock held
        self._partial, self._partial_weight = self._finalize_buffer()
        self._folded = set()
        self._rejected = set()
        self._first_fold_t = None
        self._partial_round += 1
        self._lock.notify_all()

    def _handle(self, kind, meta, tree):
        if kind == "pod_partial":
            want = int(meta["round"])
            with self._lock:
                done = self._lock.wait_for(lambda: self._partial_round >= want,
                                           timeout=self.download_timeout)
                if not done:
                    return encode_message(
                        "error", {"message": f"timeout: pod {self.pod_id} partial {want} "
                                             f"not complete (at {self._partial_round}, "
                                             f"{len(self._folded)} folded)"}, None)
                partial = (None if self._partial is None
                           else compression.host_tree(self._partial))
                return encode_message("partial", {"round": self._partial_round,
                                                  "weight": self._partial_weight}, partial)
        if kind == "install_global":
            new_round = int(meta["round"])
            g = compression.decode_tree(tree, device=self.device)
            with self._lock:
                self._global = g
                self._round = max(self._round, new_round)
                self._globals[new_round] = g
                for old in [k for k in self._globals if k <= self._round - self.keep_globals]:
                    del self._globals[old]
                if self._down is not None:
                    # the pod's round advances here: the per-site download
                    # references age on this clock
                    self._down.evict_stale(self._round, self.keep_globals)
                self._lock.notify_all()
            return encode_message("ack", {"round": self._round}, None)
        return super()._handle(kind, meta, tree)


class PodTransport:
    """The two-tier server stack and the leaders' relays of one pods run.

    The socket transports construct it, :meth:`start` it, point each site
    at :meth:`site_addrs`, then :meth:`stop` it and read :meth:`comm`.
    Leaders run as threads of the job's process: infrastructure, like the
    servers, not training sites.  Every wait is bounded by ``io_timeout``
    (a server's by half of it); a leader that fails records its error in
    ``leader_errors`` for the transport to raise."""

    def __init__(self, topology: Topology, num_sites: int, case_weights: List[float],
                 masks: np.ndarray, intra_scheduler: RoundScheduler,
                 inter_scheduler: RoundScheduler, io_timeout: float = 120.0,
                 wire: Optional[WireConfig] = None, lease_ttl: Optional[float] = None,
                 start_round: int = 0, initial_global: Any = None, ckpt_store=None,
                 ckpt_every: int = 10, codec=None, error_feedback: bool = True,
                 down_codec=None, mask_secret: Optional[str] = None, aggregator=None,
                 max_upload_norm: Optional[float] = None, initial_down=None, device=None):
        topology.validate(num_sites)
        # a rank rule applies at the INTRA tier (each pod defends against
        # its own members); the root folds the pods' partials plainly
        self.aggregator = aggregator
        self.max_upload_norm = max_upload_norm
        self.codec = codec if codec is not None and codec.name != "none" else None
        self.error_feedback = error_feedback
        self.down_codec = (down_codec if down_codec is not None and down_codec.name != "none"
                           else None)
        self.initial_down = initial_down
        self.mask_secret = mask_secret
        self.topology = topology
        self.num_sites = num_sites
        self.case_weights = list(case_weights)
        self.masks = np.asarray(masks, bool)
        self.rounds = self.masks.shape[0]
        self.intra_scheduler = intra_scheduler
        self.inter_scheduler = inter_scheduler
        self.io_timeout = io_timeout
        self.wire = wire
        self.lease_ttl = lease_ttl
        self.start_round = int(start_round)
        self.initial_global = initial_global
        self.ckpt_store = ckpt_store
        self.ckpt_every = ckpt_every
        self.device = device
        self.pod_of = topology.pod_of(num_sites)
        self.root: Optional[AggregationServer] = None
        self.pod_servers: List[PodAggregationServer] = []
        self._leaders: List[threading.Thread] = []
        self.leader_errors: Dict[int, str] = {}

    def _pod_active_rows(self) -> np.ndarray:
        """[rounds, P] bool: pod p has an active site in round r (the pod
        tier's schedule: the root's masks and the leaders' participants)."""
        rows = np.zeros((self.rounds, self.topology.num_pods), bool)
        for q in range(self.topology.num_pods):
            rows[:, q] = self.masks[:, self.pod_of == q].any(axis=1)
        return rows

    def start(self) -> "PodTransport":
        p = self.topology.num_pods
        root_sa, pod_sa = None, [None] * p
        if self.mask_secret is not None:
            from repro_torch.privacy import SecureAggState
            root_sa = SecureAggState(self.mask_secret, "pod", self._pod_active_rows())
            # each pod server schedules only its own members
            pod_sa = [SecureAggState(self.mask_secret, "site",
                                     self.masks & (self.pod_of == q)[None, :])
                      for q in range(p)]
        # the root's "sites" are pod ids; each partial's weight rides its upload
        self.root = AggregationServer(
            "127.0.0.1", 0, num_sites=p, download_timeout=self.io_timeout / 2,
            scheduler=self.inter_scheduler, wire=self.wire,
            initial_round=self.start_round, initial_global=self.initial_global,
            ckpt_store=self.ckpt_store, ckpt_every=self.ckpt_every, secure_agg=root_sa,
            down_compression=self.down_codec, initial_down=self.initial_down,
            device=self.device)
        # pod servers keep the global site ids (uploads carry them);
        # intra="uniform" folds every member at weight 1
        intra_w = None if self.topology.intra == "uniform" else self.case_weights
        self.pod_servers = [
            PodAggregationServer("127.0.0.1", 0, num_sites=self.num_sites,
                                 case_weights=intra_w,
                                 download_timeout=self.io_timeout / 2,
                                 scheduler=self.intra_scheduler, pod_id=i, wire=self.wire,
                                 lease_ttl=self.lease_ttl, initial_round=self.start_round,
                                 initial_global=self.initial_global, secure_agg=pod_sa[i],
                                 aggregator=self.aggregator,
                                 max_upload_norm=self.max_upload_norm,
                                 down_compression=self.down_codec, device=self.device)
            for i in range(p)]
        self._leaders = [threading.Thread(target=self._leader, args=(i,), daemon=True)
                         for i in range(p)]
        for t in self._leaders:
            t.start()
        return self

    def stop(self):
        """Tear the servers and relays down; leader failures stay in
        ``leader_errors``."""
        for t in self._leaders:
            t.join(timeout=5)
        for s in self.pod_servers:
            s.stop()
        if self.root is not None:
            self.root.stop()

    @property
    def rejected_uploads(self) -> int:
        """Sanitation rejections at both tiers."""
        total = sum(s.rejected_uploads for s in self.pod_servers)
        return total + (self.root.rejected_uploads if self.root is not None else 0)

    def site_addrs(self) -> Dict[int, Any]:
        """Each site's aggregation address: its pod's server."""
        return {i: self.pod_servers[int(self.pod_of[i])].addr for i in range(self.num_sites)}

    def _active_pods(self, r: int) -> int:
        """Pods with an active site in round ``r``: the root barrier's
        ``expected`` (a fully offline pod misses the round)."""
        return int(active_pod_counts(self.topology, self.masks[r:r + 1])[0])

    def _leader(self, pod_id: int):
        """The hub's relay (Algorithm 1, hub side) for ``pod_id``."""
        from repro_torch.comms.peer import Peer
        peer = Peer(site_id=pod_id, wire=self.wire)
        chan = make_channel(self.pod_servers[pod_id].addr, timeout=self.io_timeout,
                            wire=self.wire, identity=f"leader:{pod_id}")
        dev = self.pod_servers[pod_id].device
        buffered = isinstance(self.inter_scheduler, BufferedScheduler)
        mine = self.pod_of == pod_id
        base_round = self.start_round   # root round of the last pulled global
        partials = 0    # partials the pod has made: one a round with an active member
        comp = reference = sa = None
        if self.codec is not None:
            comp = compression.UploadCompressor(self.codec, self.error_feedback, port=False)
        down = self.down_codec is not None
        pull = compression.GlobalPull(down, chunk=getattr(self.down_codec, "chunk", 1024),
                                      device=dev)
        if self.mask_secret is not None:
            from repro_torch.privacy import SecureAggClient
            sa = SecureAggClient(self.mask_secret, "pod", pod_id)
            pod_rows = self._pod_active_rows()
        try:
            for r in range(self.start_round, self.rounds):
                partial = None
                # a buffered root: staleness anchored to the last pulled root
                # global, as a site's
                upload_round, want = compression.edge_rounds(buffered, r, base_round)
                if bool((self.masks[r] & mine).any()):
                    partials += 1
                    _, pmeta, partial = chan.request("pod_partial", {"round": partials})
                    # inter="uniform" weights active pods equally
                    pw = 1.0 if self.topology.inter == "uniform" else float(pmeta["weight"])
                    payload, xmeta = partial, {"weight": pw}
                    if sa is not None:          # the root sees the masked sum only
                        payload, xmeta = sa.encode(partial, pw, np.flatnonzero(pod_rows[r]), r)
                    elif comp is not None:
                        payload, xmeta = comp.encode_against(
                            compression.decode_tree(partial, device=dev), reference,
                            base_round, upload_round)
                        xmeta["weight"] = pw
                    peer.upload(self.root.addr, payload, upload_round,
                                active_sites=self._active_pods(r), meta_extra=xmeta)
                g, pulled = pull.pull(peer, self.root.addr, want)
                if g is not None:
                    base_round = pulled
                    if comp is not None:    # the next delta anchors to this pull
                        reference = g if down else compression.decode_tree(g, device=dev)
                    if down:
                        g = compression.host_tree(g)
                elif partial is not None:
                    # a buffered root with nothing finalized yet: the pod goes
                    # on from its own partial (FedBuff: proceed with what you
                    # have) rather than leave its sites waiting for an install
                    g = partial
                if g is not None:
                    chan.request("install_global", {"round": r + 1}, g)
        except Exception as e:  # noqa: BLE001 -- the transport raises it
            self.leader_errors[pod_id] = f"{type(e).__name__}: {e}"
        finally:
            chan.close()
            peer.close()

    def comm(self, compression_name: str = "none",
             down_compression: str = "none") -> Dict[str, Any]:
        """The per-tier byte split: intra = sites <-> pod servers, summed
        over pods; cross = leaders <-> root (the slow link)."""
        intra_up = intra_down = intra_count = down_count = 0
        for s in self.pod_servers:
            snap = s.stats.snapshot()
            intra_up += snap.get("upload", {}).get("in_bytes", 0)
            intra_down += snap.get("download", {}).get("out_bytes", 0)
            intra_count += snap.get("upload", {}).get("count", 0)
            down_count += snap.get("download", {}).get("count", 0)
        rsnap = self.root.stats.snapshot() if self.root else {}
        cross_up = rsnap.get("upload", {}).get("in_bytes", 0)
        cross_down = rsnap.get("download", {}).get("out_bytes", 0)
        return {"upload_bytes": intra_up + cross_up,
                "download_bytes": intra_down + cross_down,
                "total_bytes": intra_up + cross_up + intra_down + cross_down,
                "intra_pod_upload_bytes": intra_up,
                "intra_pod_download_bytes": intra_down,
                "cross_pod_upload_bytes": cross_up,
                "cross_pod_download_bytes": cross_down,
                "upload_count": intra_count, "download_count": down_count,
                "pods": self.topology.num_pods,
                "compression": compression_name,
                "down_compression": down_compression, "simulated": False}
