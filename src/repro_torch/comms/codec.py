"""Tree wire codec with length-prefixed framing, ported from ``repro/comms/codec.py``.

Byte-compatible with the reference: the same frame

    [4B magic][4B header_len][header json][payload...]

the same JSON header (``kind``, ``meta``, the tree's skeleton and one
positional ``(dtype, shape, offset)`` record per array) and the same
raw little-endian payload, so a port peer and a JAX peer read each
other's messages.  Trees are nested dicts, lists and tuples whose leaves
are numpy arrays, :class:`QuantizedTensor` or :class:`MaskedTensor`.

The port adds :func:`payload_span`: on receive the decoded arrays are
zero-copy views into the frame, and the span they cover (with each
array's byte offset in it) is what the device decode copies to the card
in one transfer.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b"FKBP"
_HDR = struct.Struct("<4sI")

#: Wire protocol generation, sent in every channel's ``hello``; a server of
#: another generation refuses the connection with a typed error.
PROTOCOL_VERSION = 1


def chunk_spans(total: int, size: int) -> List[Tuple[int, int]]:
    """(start, end) byte spans that cut ``total`` bytes into ``size``-byte
    chunks: the split of a streamed upload."""
    if size <= 0:
        raise ValueError(f"chunk size must be positive, got {size}")
    return [(a, min(a + size, total)) for a in range(0, max(total, 1), size)]


@dataclasses.dataclass
class QuantizedTensor:
    """A compressed tree leaf on the wire.

    ``codec`` names the compression scheme (see
    :func:`repro_torch.comms.compression.resolve_codec`), ``shape`` is the
    logical shape the tensor dequantizes back to, and ``data`` holds the
    codec's component arrays as host numpy arrays (quantized values,
    scales).  ``meta`` carries small codec-specific scalars.
    """

    codec: str
    shape: Tuple[int, ...]
    data: Dict[str, np.ndarray]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        """Payload bytes this leaf contributes to the wire."""
        return sum(np.asarray(a).nbytes for a in self.data.values())


@dataclasses.dataclass
class MaskedTensor:
    """A secure-aggregation leaf on the wire: ``data["v"]`` holds int64
    fixed-point masked words.  The port decodes it; it never produces one
    (secure aggregation is not ported)."""

    shape: Tuple[int, ...]
    data: Dict[str, np.ndarray]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        """Payload bytes this leaf contributes to the wire."""
        return sum(np.asarray(a).nbytes for a in self.data.values())


def _flatten(obj: Any, prefix: str, leaves: List[Tuple[str, np.ndarray]]):
    if isinstance(obj, (MaskedTensor, QuantizedTensor)):
        data_sk = {k: _flatten(obj.data[k], f"{prefix}/{k}", leaves)
                   for k in sorted(obj.data)}
        if isinstance(obj, MaskedTensor):
            node = {"shape": list(obj.shape), "data": data_sk}
        else:
            node = {"codec": obj.codec, "shape": list(obj.shape), "data": data_sk}
        if obj.meta:
            node["meta"] = obj.meta
        return {"__masked__" if isinstance(obj, MaskedTensor) else "__quant__": node}
    if isinstance(obj, dict):
        return {k: _flatten(obj[k], f"{prefix}/{k}", leaves) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        sk = [_flatten(v, f"{prefix}/{i}", leaves) for i, v in enumerate(obj)]
        return {"__list__": sk} if isinstance(obj, list) else {"__tuple__": sk}
    arr = np.asarray(obj)
    leaves.append((prefix, arr))
    return {"__leaf__": len(leaves) - 1}


def _unflatten(sk: Any, leaves: List[np.ndarray]) -> Any:
    if isinstance(sk, dict):
        if "__leaf__" in sk:
            return leaves[sk["__leaf__"]]
        if "__quant__" in sk:
            q = sk["__quant__"]
            return QuantizedTensor(
                codec=q["codec"], shape=tuple(q["shape"]),
                data={k: _unflatten(v, leaves) for k, v in q["data"].items()},
                meta=q.get("meta", {}))
        if "__masked__" in sk:
            m = sk["__masked__"]
            return MaskedTensor(
                shape=tuple(m["shape"]),
                data={k: _unflatten(v, leaves) for k, v in m["data"].items()},
                meta=m.get("meta", {}))
        if "__list__" in sk:
            return [_unflatten(v, leaves) for v in sk["__list__"]]
        if "__tuple__" in sk:
            return tuple(_unflatten(v, leaves) for v in sk["__tuple__"])
        return {k: _unflatten(v, leaves) for k, v in sk.items()}
    raise ValueError(f"bad skeleton node: {sk!r}")


def encode_message(kind: str, meta: Dict[str, Any], tree: Any = None) -> bytes:
    """Serialize (kind, metadata, optional tree of arrays) to wire bytes."""
    leaves: List[Tuple[str, np.ndarray]] = []
    skeleton = _flatten(tree, "", leaves) if tree is not None else None
    records = []
    payload = io.BytesIO()
    offset = 0
    for _name, arr in leaves:
        buf = np.ascontiguousarray(arr)   # promotes 0-d to 1-d; keep arr.shape
        records.append({"dtype": str(buf.dtype),
                        "shape": list(arr.shape), "offset": offset})
        payload.write(buf.tobytes())
        offset += buf.nbytes
    header = json.dumps({"kind": kind, "meta": meta, "skeleton": skeleton,
                         "records": records}).encode()
    return _HDR.pack(MAGIC, len(header)) + header + payload.getvalue()


def read_header(data: bytes) -> Tuple[Dict[str, Any], int]:
    """``(header, base)``: the decoded JSON header and the payload's byte
    offset in the frame; record ``i``'s array starts at
    ``base + header["records"][i]["offset"]``."""
    magic, hlen = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("bad magic — not a FedKBP+ frame")
    header = json.loads(bytes(data[_HDR.size: _HDR.size + hlen]).decode())
    return header, _HDR.size + hlen


def decode_message(data: bytes, *, writable: bool = False
                   ) -> Tuple[str, Dict[str, Any], Any]:
    """Wire bytes -> (kind, metadata, tree).  Leaves are zero-copy
    read-only views into ``data`` unless ``writable=True`` asks for owned
    copies."""
    header, base = read_header(data)
    leaves = []
    for rec in header["records"]:
        count = 1
        for d in rec["shape"]:
            count *= d
        arr = np.frombuffer(data, dtype=np.dtype(rec["dtype"]), count=count,
                            offset=base + rec["offset"]).reshape(tuple(rec["shape"]))
        leaves.append(arr.copy() if writable else arr)
    tree = _unflatten(header["skeleton"], leaves) if header["skeleton"] is not None else None
    return header["kind"], header["meta"], tree


def _root(a: np.ndarray):
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a.base if a.base is not None else a


def _address(a: np.ndarray) -> int:
    return a.ctypes.data


def payload_span(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[int]]:
    """``(span, offsets)``: one uint8 array that covers every array of
    ``arrays`` and each array's byte offset in it.  Arrays decoded from one
    frame are views into it, so the span is a zero-copy view of the frame's
    payload; arrays that do not share one buffer are packed into a fresh
    one, laid out as :func:`encode_message` lays out a payload."""
    arrays = [np.asarray(a) for a in arrays]
    if not arrays:
        return np.zeros(0, np.uint8), []
    roots = {id(_root(a)) for a in arrays}
    if len(roots) == 1 and all(a.flags.c_contiguous for a in arrays):
        starts = [_address(a) for a in arrays]
        lo = min(starts)
        hi = max(s + a.nbytes for s, a in zip(starts, arrays))
        root = _root(arrays[0])
        try:
            frame = root.reshape(-1).view(np.uint8) if isinstance(root, np.ndarray) \
                else np.frombuffer(root, np.uint8)
        except (TypeError, ValueError):      # not a buffer (a tensor's array, say)
            frame = None
        start = lo - _address(frame) if frame is not None else -1
        if 0 <= start and start + hi - lo <= frame.size:
            return frame[start: start + hi - lo], [s - lo for s in starts]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += a.nbytes
    span = np.empty(total, np.uint8)
    for a, o in zip(arrays, offsets):
        span[o: o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return span, offsets


def frame(data: bytes) -> bytes:
    """Length-prefix a message for the TCP stream."""
    return struct.pack("<Q", len(data)) + data


def read_frame(sock) -> bytes:
    """Read one length-prefixed message from a socket (blocking)."""
    hdr = _read_exact(sock, 8)
    (n,) = struct.unpack("<Q", hdr)
    return _read_exact(sock, n)


def _read_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed while reading frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
