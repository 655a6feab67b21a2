"""TCP transport, ported from ``repro/comms/transport.py``: the offline
stand-in for the paper's gRPC channel.

Sites are addressed by (host, port), so they can share one workstation or
spread over machines.  One OS thread per accepted connection; every
message is a framed codec blob (:mod:`repro_torch.comms.codec`), byte for
byte the reference's, so port and JAX peers share one wire.

The wire is sessioned: every connection opens with a ``hello`` carrying
the protocol version and, when the job has a shared secret, an
HMAC-SHA256 token.  One :class:`WireConfig` sets auth and TLS, streamed
uploads (a message above ``max_message_size`` crosses as begin / chunk /
commit frames, reassembled byte-identically before dispatch) and
retry/reconnect with capped exponential backoff (servers dedup replayed
uploads and chunks).  :class:`FlakyChannel` injects drop/dup/delay/corrupt
faults for tests.

Pure Python and numpy: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import socket
import ssl
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comms.codec import (PROTOCOL_VERSION, chunk_spans, decode_message,
                               encode_message, frame, read_frame)

Address = Tuple[str, int]

Handler = Callable[[str, Dict[str, Any], Any], Optional[bytes]]

# connection-layer message kinds, handled before the app handler sees them
HELLO = "__hello__"
STREAM_BEGIN = "__stream_begin__"
STREAM_CHUNK = "__stream_chunk__"
STREAM_COMMIT = "__stream_commit__"


# ---------------------------------------------------------------------------
# Typed wire errors
# ---------------------------------------------------------------------------


class WireError(RuntimeError):
    """Base class for typed transport failures.  Subclasses RuntimeError
    so pre-protocol callers that catch/assert RuntimeError keep working;
    the ``code`` rides the error reply so the *client* re-raises the
    same type the server raised."""

    code = "wire"


class AuthError(WireError):
    """Missing/bad auth token in ``hello``, or an rpc before handshake."""

    code = "auth"


class ProtocolVersionError(WireError):
    """Peer speaks a different PROTOCOL_VERSION."""

    code = "version"


class ChannelError(WireError):
    """Channel exhausted its reconnect budget."""

    code = "channel"


class PeerClosed(WireError):
    """The local peer was closed while a receive was pending."""

    code = "closed"


class CorruptFrameError(WireError):
    """A frame arrived but its payload would not decode (byte-level wire
    corruption).  Retriable client-side: the sender's copy is intact, so
    the request is simply resent — only an exhausted retry budget turns
    corruption into a terminal :class:`ChannelError`."""

    code = "corrupt"


_ERROR_CODES = {cls.code: cls for cls in
                (WireError, AuthError, ProtocolVersionError, ChannelError,
                 PeerClosed, CorruptFrameError)}


def raise_remote_error(addr: Address, rmeta: Dict[str, Any]):
    """Re-raise a server error reply client-side, typed via its code."""
    cls = _ERROR_CODES.get(rmeta.get("code"), RuntimeError)
    raise cls(f"remote error from {addr}: {rmeta['message']}")


# ---------------------------------------------------------------------------
# Wire configuration (shared by servers and channels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WireConfig:
    """Deployable-wire settings: auth, TLS, streaming, retry, faults.

    One instance is threaded from :class:`repro_torch.api.FederatedJob` through
    every server and channel of a job (it is picklable, so tcp site
    processes inherit it).  All fields default to the permissive
    test-rig behavior — a default ``WireConfig()`` speaks the same
    protocol but requires no secret, no TLS and never streams.

    ``secret``            — shared job secret; when set, every channel
                            sends ``HMAC-SHA256(secret, "{version}:{identity}")``
                            in its hello and the server verifies it.
    ``tls_cert``/``tls_key`` — PEM paths; cert alone on clients (pinned
                            trust anchor), cert+key on servers.
    ``max_message_size``  — encoded messages above this many bytes are
                            chunk-streamed instead of sent as one frame.
    ``connect_retries``   — reconnect attempts per request on socket
                            failure (capped exponential backoff between
                            attempts: ``backoff_base * 2**k``, at most
                            ``backoff_cap`` seconds).
    ``flaky``             — fault-injection spec for tests, e.g.
                            ``"drop=0.2,dup=0.1,delay=0.005,corrupt=0.02,
                            seed=3"`` (see :class:`FlakyChannel`).
    """

    secret: Optional[str] = None
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    max_message_size: Optional[int] = None
    connect_retries: int = 4
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    flaky: Optional[str] = None

    @property
    def tls(self) -> bool:
        return bool(self.tls_cert)

    def token(self, identity: str) -> Optional[str]:
        """Per-identity auth token: HMAC over the protocol version and
        the peer identity, keyed by the shared job secret."""
        if self.secret is None:
            return None
        msg = f"{PROTOCOL_VERSION}:{identity}".encode()
        return hmac.new(self.secret.encode(), msg, hashlib.sha256).hexdigest()

    def check_token(self, identity: str, token: Optional[str]) -> bool:
        want = self.token(identity)
        if want is None or token is None:
            return False
        return hmac.compare_digest(want, str(token))

    def server_ssl(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.tls_cert, self.tls_key)
        return ctx

    def client_ssl(self) -> ssl.SSLContext:
        # self-signed deployment: the client pins the server cert as its
        # trust anchor and skips hostname checks (sites dial by IP)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(self.tls_cert)
        return ctx


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Capped exponential backoff before reconnect ``attempt`` (1-based)."""
    return min(cap, base * (2.0 ** (attempt - 1)))


def _decode_checked(data: bytes, writable: bool = False):
    """Decode a frame, surfacing garbled bytes as the typed
    :class:`CorruptFrameError` (its code rides the error reply, so the
    client retries instead of treating the wire as dead — and a barrier
    never hangs on an upload whose bytes were mangled in flight)."""
    try:
        return decode_message(data, writable=writable)
    except Exception as e:  # noqa: BLE001 — any codec failure is corruption
        raise CorruptFrameError(
            f"undecodable frame ({len(data)} bytes): {e!r}") from e


class WireStats:
    """Thread-safe per-message-kind byte counters for a :class:`Server`.

    Counts the framed request/reply bytes that actually cross the wire
    (payload + header; the 8-byte frame prefix excluded), keyed by rpc
    kind — so an ``AggregationServer`` can report exactly how many
    upload bytes it received and download bytes it served, with or
    without compression (see ``benchmarks/comm_bytes.py``).  Streamed
    chunks add their bytes under the inner rpc kind with ``count=0``;
    only the commit increments the rpc count, so a chunked upload still
    counts as one upload.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._by_kind: Dict[str, list] = {}

    def add(self, kind: str, bytes_in: int, bytes_out: int,
            count: int = 1) -> None:
        with self._lock:
            row = self._by_kind.setdefault(kind, [0, 0, 0])
            row[0] += int(bytes_in)
            row[1] += int(bytes_out)
            row[2] += int(count)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {k: {"in_bytes": v[0], "out_bytes": v[1], "count": v[2]}
                    for k, v in self._by_kind.items()}


class Server:
    """Threaded request/response TCP server.

    ``handler(kind, meta, tree) -> reply bytes | None`` runs on the
    connection thread; exceptions are returned to the caller as an
    ``error`` message (mirroring gRPC status codes) carrying the typed
    error ``code`` when the exception is a :class:`WireError`.

    ``decode_writable=True`` hands the handler writable array leaves
    (copies) instead of zero-copy read-only views — for handlers that
    mutate payloads in place (e.g. the streaming aggregation server).

    With a ``wire`` config the connection layer enforces the protocol:
    TLS wrap on accept, ``hello`` version/token verification before any
    rpc is dispatched, and reassembly of chunk-streamed messages — app
    handlers never see handshake or stream frames.
    """

    def __init__(self, host: str, port: int, handler: Handler,
                 decode_writable: bool = False,
                 stats: Optional[WireStats] = None,
                 wire: Optional[WireConfig] = None):
        self.addr: Address = (host, port)
        self.handler = handler
        self.decode_writable = decode_writable
        self.stats = stats
        self.wire = wire
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self.addr)
        self.addr = self._sock.getsockname()       # resolve port 0
        # cross-device scale: hundreds of sites dial in within the same
        # round tick (each Peer holds ONE pooled Channel per address, but
        # all of them connect at job start) — a backlog of 64 refused the
        # burst past ~64 concurrent connects.  The kernel clamps this to
        # net.core.somaxconn, so asking high is safe everywhere.
        self._sock.listen(1024)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self) -> "Server":
        self._thread.start()
        return self

    def _serve(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _hello_reply(self, meta: Dict[str, Any]) -> bytes:
        proto = int(meta.get("proto", -1))
        if proto != PROTOCOL_VERSION:
            raise ProtocolVersionError(
                f"protocol version mismatch: peer speaks v{proto}, "
                f"server speaks v{PROTOCOL_VERSION}")
        if self.wire is not None and self.wire.secret is not None:
            identity = str(meta.get("peer", ""))
            if not self.wire.check_token(identity, meta.get("token")):
                raise AuthError(
                    f"bad or missing auth token for peer {identity!r}")
        return encode_message("welcome", {"proto": PROTOCOL_VERSION}, None)

    def _handle_conn(self, conn: socket.socket):
        if self.wire is not None and self.wire.tls:
            try:
                conn = self.wire.server_ssl().wrap_socket(conn,
                                                          server_side=True)
            except (ssl.SSLError, ConnectionError, OSError):
                return
        # per-connection session state: handshake flag + stream buffers
        need_auth = self.wire is not None and self.wire.secret is not None
        authed = not need_auth
        streams: Dict[str, Dict[str, Any]] = {}
        with conn:
            while not self._stop.is_set():
                try:
                    data = read_frame(conn)
                except (ConnectionError, OSError):
                    return
                stat_kind, n_rpc = "?", 1
                try:
                    kind, meta, tree = _decode_checked(
                        data, writable=self.decode_writable)
                    stat_kind = kind
                    if kind == HELLO:
                        reply = self._hello_reply(meta)
                        authed = True
                    elif not authed:
                        raise AuthError("hello handshake required before rpcs")
                    elif kind == STREAM_BEGIN:
                        streams[meta["stream"]] = {"kind": meta["kind"],
                                                   "parts": []}
                        stat_kind, n_rpc = meta["kind"], 0
                        reply = encode_message("ok", {}, None)
                    elif kind == STREAM_CHUNK:
                        st = streams[meta["stream"]]
                        stat_kind, n_rpc = st["kind"], 0
                        # replayed/duplicated chunks are idempotent: only
                        # the next expected seq extends the buffer
                        if int(meta["seq"]) == len(st["parts"]):
                            st["parts"].append(np.asarray(tree["b"]).tobytes())
                        reply = encode_message("ok", {}, None)
                    elif kind == STREAM_COMMIT:
                        st = streams.pop(meta["stream"])
                        stat_kind = st["kind"]
                        whole = b"".join(st["parts"])
                        if len(whole) != int(meta["total"]):
                            raise WireError(
                                f"stream reassembly mismatch: got "
                                f"{len(whole)} bytes, expected {meta['total']}")
                        ikind, imeta, itree = _decode_checked(
                            whole, writable=self.decode_writable)
                        reply = self.handler(ikind, imeta, itree)
                        if reply is None:
                            reply = encode_message("ok", {}, None)
                    else:
                        reply = self.handler(kind, meta, tree)
                        if reply is None:
                            reply = encode_message("ok", {}, None)
                except Exception as e:  # noqa: BLE001 — wire errors to caller
                    emeta = {"message": repr(e)}
                    if isinstance(e, WireError):
                        emeta["code"] = e.code
                    reply = encode_message("error", emeta, None)
                if self.stats is not None:
                    self.stats.add(stat_kind, len(data), len(reply),
                                   count=n_rpc)
                try:
                    conn.sendall(frame(reply))
                except OSError:
                    return

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2)


class Channel:
    """Client connection to a peer/coordinator (request → response).

    ``timeout`` bounds the socket wait for a reply and must exceed any
    server-side ``wait_for`` window (the aggregation server blocks a
    download up to ``download_timeout=60`` s before replying with an
    ``error``) — otherwise the client dies on a raw ``socket.timeout``
    instead of receiving the server's actionable error reply.

    Every (re)connect replays the ``hello`` handshake.  A socket failure
    mid-request reconnects with capped exponential backoff and replays
    the request from the start (for a streamed request: the whole
    begin/chunk/commit sequence, which resets the server-side buffer).
    Auth/version rejections are terminal — they raise immediately and
    are never retried.
    """

    #: overridable for tests that need to speak a wrong version
    proto_version = PROTOCOL_VERSION

    def __init__(self, addr: Address, timeout: float = 120.0,
                 wire: Optional[WireConfig] = None, identity: str = ""):
        self.addr = addr
        self.timeout = timeout
        self.wire = wire or WireConfig()
        self.identity = identity
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stream_seq = 0
        last = None
        for attempt in range(self.wire.connect_retries + 1):
            if attempt:
                time.sleep(backoff_delay(attempt, self.wire.backoff_base,
                                         self.wire.backoff_cap))
            try:
                self._connect()
                return
            except CorruptFrameError as e:
                last = e                       # garbled hello: resend it
                self._close_sock()
            except WireError:
                raise                          # auth/version: not retriable
            except (ConnectionError, OSError) as e:
                last = e
                self._close_sock()
        raise ChannelError(f"could not connect to {self.addr} after "
                           f"{self.wire.connect_retries + 1} attempts: {last!r}")

    # -- connection lifecycle ------------------------------------------------

    def _connect(self):
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        sock.settimeout(self.timeout)
        if self.wire.tls:
            sock = self.wire.client_ssl().wrap_socket(
                sock, server_hostname=self.addr[0])
        self._sock = sock
        try:
            self._hello()
        except BaseException:
            self._close_sock()
            raise

    def _hello(self):
        meta: Dict[str, Any] = {"proto": self.proto_version,
                                "peer": self.identity}
        token = self.wire.token(self.identity)
        if token is not None:
            meta["token"] = token
        self._send_frame(frame(encode_message(HELLO, meta, None)))
        rkind, rmeta, _ = decode_message(self._recv_frame())
        if rkind == "error":
            raise_remote_error(self.addr, rmeta)

    def _close_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # frame primitives — FlakyChannel overrides these to inject faults
    def _send_frame(self, framed: bytes):
        self._sock.sendall(framed)

    def _recv_frame(self) -> bytes:
        return read_frame(self._sock)

    # -- requests ------------------------------------------------------------

    def request(self, kind: str, meta: Dict[str, Any], tree: Any = None
                ) -> Tuple[str, Dict[str, Any], Any]:
        data = encode_message(kind, meta, tree)
        mms = self.wire.max_message_size
        last = None
        # wire corruption of the FINAL frame surfaces here (the server's
        # typed "corrupt" error reply); our copy of the request is
        # intact, so resend it — like the reconnect replay, but without
        # tearing down the connection
        for attempt in range(self.wire.connect_retries + 1):
            if attempt:
                time.sleep(backoff_delay(attempt, self.wire.backoff_base,
                                         self.wire.backoff_cap))
            with self._lock:
                if mms is not None and len(data) > mms:
                    reply = self._roundtrip(
                        self._stream_frames(kind, data, mms))
                else:
                    reply = self._roundtrip([frame(data)])
            rkind, rmeta, rtree = decode_message(reply)
            if rkind == "error":
                if rmeta.get("code") == CorruptFrameError.code:
                    last = rmeta.get("message")
                    continue
                raise_remote_error(self.addr, rmeta)
            return rkind, rmeta, rtree
        raise ChannelError(
            f"request {kind!r} to {self.addr} still corrupt after "
            f"{self.wire.connect_retries + 1} attempts: {last}")

    def _stream_frames(self, kind: str, data: bytes, mms: int) -> List[bytes]:
        """Cut one encoded message into begin/chunk/commit frames."""
        sid = f"{self.identity or 'chan'}-{self._stream_seq}"
        self._stream_seq += 1
        frames = [frame(encode_message(STREAM_BEGIN,
                                       {"stream": sid, "kind": kind}, None))]
        for seq, (a, b) in enumerate(chunk_spans(len(data), mms)):
            chunk = np.frombuffer(data[a:b], dtype=np.uint8)
            frames.append(frame(encode_message(
                STREAM_CHUNK, {"stream": sid, "seq": seq}, {"b": chunk})))
        frames.append(frame(encode_message(
            STREAM_COMMIT, {"stream": sid, "total": len(data)}, None)))
        return frames

    def _roundtrip(self, frames: List[bytes]) -> bytes:
        """Send a frame sequence, reading one reply per frame; return the
        final reply.  Socket failures reconnect + replay the sequence."""
        last = None
        for attempt in range(self.wire.connect_retries + 1):
            if attempt:
                time.sleep(backoff_delay(attempt, self.wire.backoff_base,
                                         self.wire.backoff_cap))
            try:
                if self._sock is None:
                    self._connect()
                reply = b""
                for i, framed in enumerate(frames):
                    self._send_frame(framed)
                    reply = self._recv_frame()
                    if i < len(frames) - 1:
                        rkind, rmeta, _ = decode_message(reply)
                        if rkind == "error":
                            raise_remote_error(self.addr, rmeta)
                return reply
            except CorruptFrameError as e:
                # a mid-stream frame was garbled on the wire: resend the
                # whole sequence (STREAM_BEGIN resets the server buffer;
                # the connection itself is healthy, so keep it)
                last = e
            except WireError:
                raise                          # typed rejections: terminal
            except (ConnectionError, OSError) as e:
                last = e
                self._close_sock()
        raise ChannelError(f"request to {self.addr} failed after "
                           f"{self.wire.connect_retries + 1} attempts: {last!r}")

    def close(self):
        self._close_sock()


class FlakyChannel(Channel):
    """Fault-injection wrapper over :class:`Channel` for wire tests.

    ``drop``    — probability a frame send kills the connection instead
                  (exercises reconnect + replay).
    ``dup``     — probability a frame is sent twice (exercises server-side
                  dedup of replayed uploads / stream chunks; the duplicate
                  reply is drained so the stream stays in sync).
    ``delay``   — uniform[0, delay) seconds of extra latency per send.
    ``corrupt`` — probability one payload byte of a frame is flipped in
                  flight (the 8-byte length prefix stays intact, so the
                  server reads a whole frame whose decode then fails —
                  the typed ``corrupt`` reply drives the client's resend
                  path).  A flip can land where the codec still decodes:
                  a valid-but-wrong model that only the server-side
                  upload sanitation catches — which is exactly the
                  layering under test (wire-level corruption vs
                  model-level attack).

    Deterministic per ``seed``; activated end-to-end via
    ``WireConfig.flaky = "drop=0.2,dup=0.1,corrupt=0.02,seed=3"`` (see
    :func:`make_channel`).
    """

    def __init__(self, addr: Address, *, drop: float = 0.0, dup: float = 0.0,
                 delay: float = 0.0, corrupt: float = 0.0, seed: int = 0,
                 **kw):
        self.drop, self.dup, self.delay = drop, dup, delay
        self.corrupt = corrupt
        self._frng = np.random.default_rng(seed)
        self._dup_pending = 0
        super().__init__(addr, **kw)

    @staticmethod
    def parse_spec(spec: str) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            params[key.strip()] = (int(val) if key.strip() == "seed"
                                   else float(val))
        return params

    def _connect(self):
        self._dup_pending = 0                  # replies die with the socket
        super()._connect()

    def _send_frame(self, framed: bytes):
        if self.delay:
            time.sleep(float(self._frng.uniform(0.0, self.delay)))
        if self._frng.random() < self.drop:
            self._close_sock()
            raise ConnectionError("flaky wire: frame dropped")
        if (self.corrupt and len(framed) > 9
                and self._frng.random() < self.corrupt):
            # flip one payload byte past the 8-byte length prefix: the
            # frame still arrives whole, its contents are garbage
            pos = int(self._frng.integers(8, len(framed)))
            mangled = bytearray(framed)
            mangled[pos] ^= 0xFF
            framed = bytes(mangled)
        if self._frng.random() < self.dup:
            super()._send_frame(framed)
            self._dup_pending += 1
        super()._send_frame(framed)

    def _recv_frame(self) -> bytes:
        reply = super()._recv_frame()
        while self._dup_pending:               # discard duplicates' replies
            super()._recv_frame()
            self._dup_pending -= 1
        return reply


def make_channel(addr: Address, timeout: float = 120.0,
                 wire: Optional[WireConfig] = None,
                 identity: str = "") -> Channel:
    """The one Channel constructor call sites use: honors the wire
    config's fault-injection spec so flaky-wire tests exercise the very
    same peer/coordinator code paths as the clean wire."""
    if wire is not None and wire.flaky:
        return FlakyChannel(addr, **FlakyChannel.parse_spec(wire.flaky),
                            timeout=timeout, wire=wire, identity=identity)
    return Channel(addr, timeout=timeout, wire=wire, identity=identity)
