"""Site-side comms endpoint (paper Fig 4, Algorithm 1 "Site side"), ported
from ``repro/comms/peer.py``.

A ``Peer`` owns a small server socket for receiving models from other
sites (the Sender→Receiver path of decentralized FL) and client channels
to the coordinator / aggregation server.  It exposes exactly the verbs
the paper's FL scripts use:

  centralized : upload(weights) / download(round)
  decentralized: get_assignment(round) → send_model(addr) or recv_model()

A ``wire`` config (see :class:`~repro_torch.comms.transport.WireConfig`)
applies to both halves: the peer's own server enforces the handshake,
and every outgoing channel authenticates as ``site:{id}``, streams
oversized uploads, and retries dropped sockets.  ``close()`` drains the
inbox with a deadline and wakes any blocked ``recv_model`` with a typed
:class:`~repro_torch.comms.transport.PeerClosed` so site scripts exit cleanly
on shutdown instead of leaking ``queue.Empty``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional, Set, Tuple

from repro_torch.comms.codec import encode_message
from repro_torch.comms.transport import (Address, Channel, PeerClosed, Server,
                                   WireConfig, make_channel)

_CLOSED = object()   # inbox sentinel: wakes receivers blocked in close()


class Peer:
    def __init__(self, site_id: int, host: str = "127.0.0.1", port: int = 0,
                 wire: Optional[WireConfig] = None):
        self.site_id = site_id
        self.wire = wire
        self._inbox: "queue.Queue[Tuple[Dict, Any]]" = queue.Queue()
        self._closed = threading.Event()
        self._seen: Set[Tuple[int, int]] = set()
        self.server = Server(host, port, self._handle, wire=wire).start()
        self.addr: Address = self.server.addr
        self._channels: Dict[Address, Channel] = {}

    # -- incoming ----------------------------------------------------------
    def _handle(self, kind, meta, tree):
        if kind == "model":
            # a retried/duplicated send delivers the same (site, round)
            # model twice — ack it, enqueue it once
            key = (int(meta.get("site", -1)), int(meta.get("round", -1)))
            if key not in self._seen:
                self._seen.add(key)
                self._inbox.put((meta, tree))
            return encode_message("ack", {}, None)
        raise ValueError(f"unknown rpc {kind!r}")

    def recv_model(self, timeout: float = 60.0) -> Tuple[Dict, Any]:
        """Block until a peer model arrives (Receiver role).  Raises
        :class:`PeerClosed` if the peer is shut down before/while
        waiting, ``TimeoutError`` if no model arrives in time."""
        if self._closed.is_set():
            raise PeerClosed(f"peer {self.site_id} is closed")
        try:
            item = self._inbox.get(timeout=timeout)
        except queue.Empty:
            if self._closed.is_set():
                raise PeerClosed(f"peer {self.site_id} closed while "
                                 f"waiting for a model") from None
            raise TimeoutError(f"peer {self.site_id}: no model within "
                               f"{timeout}s") from None
        if item is _CLOSED:
            self._inbox.put(_CLOSED)   # wake any other blocked receiver
            raise PeerClosed(f"peer {self.site_id} closed while "
                             f"waiting for a model")
        return item

    # -- outgoing ----------------------------------------------------------
    def _channel(self, addr: Address) -> Channel:
        addr = (addr[0], int(addr[1]))
        if addr not in self._channels:
            self._channels[addr] = make_channel(
                addr, wire=self.wire, identity=f"site:{self.site_id}")
        return self._channels[addr]

    def request(self, addr: Address, kind: str, meta: Dict,
                tree: Any = None) -> Tuple[str, Dict, Any]:
        """Raw rpc against ``addr`` (join/heartbeat/leave and friends)."""
        return self._channel(addr).request(kind, meta, tree)

    def send_model(self, addr: Address, weights: Any, round_index: int,
                   meta_extra: Optional[Dict] = None):
        """Sender role: push local weights directly to the receiver site.
        ``meta_extra`` rides along (e.g. the compression codec tags the
        receiver needs to dequantize — see ``repro_torch.comms.compression``)."""
        self._channel(addr).request(
            "model",
            {"site": self.site_id, "round": round_index, **(meta_extra or {})},
            weights)

    # centralized-FL verbs
    def upload(self, server_addr: Address, weights: Any, round_index: int,
               active_sites: Optional[int] = None,
               meta_extra: Optional[Dict] = None) -> Dict:
        """Upload local weights; returns the server ack metadata (callers
        can check ``ack["stale"]`` — a rejected straggler upload).
        ``meta_extra`` carries the compression tags
        (``compression``/``delta``/``base_round``) the server's
        :func:`~repro_torch.comms.compression.decode_upload` reads."""
        meta = {"site": self.site_id, "round": round_index,
                **(meta_extra or {})}
        if active_sites is not None:
            meta["active_sites"] = active_sites
        _, ack, _ = self._channel(server_addr).request("upload", meta, weights)
        return ack

    def download(self, server_addr: Address, round_index: int,
                 with_meta: bool = False, down: bool = False,
                 acked_round: Optional[int] = None) -> Any:
        """Block until the server completes ``round_index`` and return the
        global model; ``with_meta=True`` also returns the reply metadata
        (``meta["round"]`` = the server round actually served — under a
        buffered scheduler it may be ahead of the requested one).

        ``down=True`` opts into compressed downloads: the request then
        carries this site's identity and ``acked_round`` — the round of
        the last download it decoded — so a down-compressing server can
        serve a quantized delta against the site's held global (any
        disagreement, or ``acked_round=None``, gets a dense bootstrap
        reply; see ``compression.DownlinkCompressor``).  The reply meta
        then carries ``compression``/``delta`` tags for
        ``decode_download``."""
        meta: Dict[str, Any] = {"round": round_index, "site": self.site_id}
        if down:
            meta["down"] = True
            if acked_round is not None:
                meta["acked_round"] = int(acked_round)
        _, meta, tree = self._channel(server_addr).request(
            "download", meta, None)
        return (tree, meta) if with_meta else tree

    def register(self, coord_addr: Address):
        self._channel(coord_addr).request(
            "register", {"site": self.site_id, "addr": list(self.addr)}, None)

    def get_assignment(self, coord_addr: Address, round_index: int) -> Dict:
        _, meta, _ = self._channel(coord_addr).request(
            "get_assignment", {"round": round_index}, None)
        return meta

    def status_update(self, coord_addr: Address, active: bool):
        self._channel(coord_addr).request(
            "status_update", {"site": self.site_id, "active": active}, None)

    def close(self, deadline: float = 1.0):
        """Shut the peer down cleanly: mark closed (new/blocked
        ``recv_model`` calls raise :class:`PeerClosed`), give in-flight
        sender pushes up to ``deadline`` seconds to finish their ack
        round-trip, then close channels and the server socket."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._inbox.put(_CLOSED)
        # drain the receiving half: models already queued (or acked right
        # now on a connection thread) are consumed, not stranded
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                break
            if item is _CLOSED:
                self._inbox.put(_CLOSED)  # keep the sentinel for receivers
                break
        for ch in self._channels.values():
            ch.close()
        self.server.stop()
