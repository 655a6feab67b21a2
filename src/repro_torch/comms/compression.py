"""The int8 wire codec, ported from ``repro/comms/compression.py``.

Uploads (and, with downlink compression, broadcasts) ride a codec seam.
The socket deployment's halves are here too: :class:`UploadCompressor`
(a site's delta, error feedback and codec), :func:`decode_upload`,
:class:`DownlinkCompressor` (the server's per-site held references) and
:func:`decode_download`, all on the device of the trees they are given.
Ported: ``none`` and ``int8`` (per-chunk absmax int8, 4x smaller than
fp32).  ``fp8`` and the top-k sparsifiers raise
:class:`~repro_torch.NotPorted`; they are never swapped for int8.

Quantization granularity is a contiguous chunk of the flattened leaf (one
fp32 scale per chunk), laid out by :func:`chunk_geom`, the one geometry
rule that the wire codec and the round engine's on-device codec share, so
scales and byte counts agree by construction.  The layout follows the
device, as the reference's follows its backend: a CUDA tensor is chunked
at ``align=128`` and quantized by the CUDA kernel, a CPU tensor at
``align=1`` by the kernel's plain version.  Either way the values are the
reference numpy encoder's, bit for bit; only the padding, and so the byte
count, differs.

A model crosses the wire in the reference's layout (conv weights DHWIO)
through a :class:`WirePlan`: a site gathers its OIDHW buffer into the
wire's element order at its edge, quantizes it in one launch per chunk
width and copies it to the host once; every received message is copied
to the device in one transfer and every int8 leaf of it decoded by ONE
``dequantize_int8`` launch (:func:`decode_tree`).  ``Int8Codec`` itself
encodes an array in the order it is given: a port model never goes to the
wire through it.

Importing this module imports no kernel: the kernels import
:data:`MIN_SCALE` from here.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import NotPorted
from repro_torch.comms.codec import MaskedTensor, QuantizedTensor, payload_span
from repro_torch.tree import tree_leaves, tree_map

# absmax-0 chunks quantize to 0 instead of dividing by 0: THE scale floor,
# shared by the kernels and their plain versions
MIN_SCALE = np.float32(1e-12)

# how many recent globals the aggregation point keeps as delta decode
# references; a site whose last exchange is this many rounds old or more
# bootstraps dense
KEEP_GLOBALS_DEFAULT = 16

ACCEL_ALIGN = 128


def align_for(device: torch.device) -> int:
    """The chunk alignment for ``device``: 128 on CUDA, 1 on the CPU."""
    return ACCEL_ALIGN if torch.device(device).type == "cuda" else 1


def tree_payload_nbytes(tree: Any) -> int:
    """Wire payload bytes of a tree whose leaves are tensors, numpy arrays
    and/or :class:`QuantizedTensor` (framing excluded)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, QuantizedTensor):
            total += x.nbytes
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        else:
            total += np.asarray(x).nbytes
    return total


def chunk_geom(n: int, chunk: int, align: int = 1) -> Tuple[int, int]:
    """(rows, width) of the quantization chunk matrix for an n-element
    leaf.  A leaf smaller than ``chunk`` gets one row of its own size,
    rounded up to ``align``, so small leaves pay no full chunk of padding."""
    c = min(chunk, max(-(-n // align) * align, align))
    return (-(-n // c) if n else 0), c


def _as_chunks(flat: torch.Tensor, chunk: int, align: int = 1) -> torch.Tensor:
    """1-D fp32 -> zero-padded [C, chunk] matrix via :func:`chunk_geom`."""
    rows, width = chunk_geom(flat.numel(), chunk, align)
    if rows * width != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, rows * width - flat.numel()))
    return flat.reshape(rows, width)


@dataclasses.dataclass
class Codec:
    """One leaf-wise compression scheme.  ``encode_array`` maps a tensor
    to a :class:`QuantizedTensor` (or passes it through); decoding needs
    no codec instance: :func:`decode_array` reads the leaf's tag."""

    name = "none"

    def encode_array(self, arr):
        return arr

    def encode_tree(self, tree: Any) -> Any:
        return tree_map(self.encode_array, tree)


@dataclasses.dataclass
class NoneCodec(Codec):
    """Identity codec: the payload is the uncompressed model."""

    name = "none"


@dataclasses.dataclass
class Int8Codec(Codec):
    """Per-chunk absmax int8: values q in [-127, 127], one fp32 scale per
    ``chunk`` elements (absmax/127)."""

    chunk: int = 1024

    name = "int8"

    def encode_array(self, arr) -> QuantizedTensor:
        """Quantize one leaf where it lies: the CUDA kernel for a CUDA
        tensor, the plain version for a CPU one.  The payload is host numpy."""
        from repro_torch.kernels import ops
        x = torch.as_tensor(arr).float()
        mat = _as_chunks(x.reshape(-1), self.chunk, align_for(x.device))
        q, s = ops.quantize_int8(mat.contiguous())
        return QuantizedTensor("int8", tuple(x.shape),
                               {"q": q.cpu().numpy(), "scale": s.cpu().numpy()})


def _decode_int8(qt: QuantizedTensor, device) -> torch.Tensor:
    from repro_torch.kernels import ops
    q = torch.from_numpy(np.ascontiguousarray(qt.data["q"])).to(device)
    s = torch.from_numpy(np.asarray(qt.data["scale"], np.float32)).to(device)
    flat = ops.dequantize_int8(q, s).reshape(-1)
    size = int(np.prod(qt.shape, dtype=np.int64))
    return flat[:size].reshape(qt.shape)


def decode_array(leaf, *, device) -> torch.Tensor:
    """Dequantize one leaf onto ``device``: a CUDA device launches the
    ``dequantize_int8`` kernel, the CPU takes its plain version.  A plain
    array passes through (moved to ``device``)."""
    if isinstance(leaf, QuantizedTensor):
        if leaf.codec != "int8":
            raise ValueError(f"unknown quantized-tensor codec {leaf.codec!r}")
        return _decode_int8(leaf, device)
    return torch.as_tensor(leaf, device=device)


_CODECS = {"none": NoneCodec, "int8": Int8Codec}
_UNPORTED = ("fp8", "topk", "topk-sparse", "topk-fixed")


def codec_name(spec: Union[str, Codec, None]) -> str:
    """The name of a codec spec, unresolved: the composition guards read it
    before an unported codec raises, as the reference's do."""
    if spec is None:
        return "none"
    if isinstance(spec, Codec):
        return spec.name
    if spec in _CODECS or spec in _UNPORTED:
        return spec
    raise KeyError(f"unknown compression codec {spec!r}; known: "
                   f"{sorted(_CODECS) + list(_UNPORTED)}")


def resolve_codec(spec: Union[str, Codec, None], seam: str = "compression") -> Codec:
    """``None``, a name or a :class:`Codec` -> a :class:`Codec`.  The
    reference's other codecs raise :class:`~repro_torch.NotPorted` naming
    ``seam`` (the job field that asked for them)."""
    if spec is None:
        return NoneCodec()
    if isinstance(spec, Codec):
        return spec
    if spec in _CODECS:
        return _CODECS[spec]()
    if spec in _UNPORTED:
        raise NotPorted(seam, repr(spec), "'none', 'int8'")
    raise KeyError(f"unknown compression codec {spec!r}; known: "
                   f"{sorted(_CODECS) + list(_UNPORTED)}")


# ---------------------------------------------------------------------------
# Models on the wire: the reference's layout, decoded on the device
# ---------------------------------------------------------------------------


class WirePlan:
    """How one model layout crosses the wire, on one device.

    ``port=True``: the flat buffers are the port's (conv weights OIDHW) and
    :meth:`to_wire` / :meth:`to_port` gather between them and the wire's
    element order (leaves in flatten order, each in the reference's
    layout); ``port=False``: the buffers already hold the wire's order.
    :meth:`encode` quantizes a buffer leaf by leaf as the reference's
    codec does (one ``quantize_int8`` launch per chunk width),
    :meth:`dequantize` decodes that encode on the device in one launch, and
    :meth:`decode` a received message of the model."""

    _CACHE: Dict[Any, "WirePlan"] = {}

    def __init__(self, layout, chunk: int, align: int, device: torch.device, port: bool):
        from repro_torch import convert
        from repro_torch.core.agg_engine import RavelLayout
        from repro_torch.core.round_engine import ChunkPlan
        from repro_torch.kernels.quantize import Int8Table
        self.layout, self.device = layout, torch.device(device)
        self.chunks = ChunkPlan.of(layout, chunk, align, self.device, reorder=port)
        orders = [convert.reference_order(sh) if port else None for sh in layout.shapes]
        shapes = tuple(sh if o is None else tuple(sh[i] for i in o)
                       for sh, o in zip(layout.shapes, orders))
        self.wire = RavelLayout(layout.treedef, shapes, (torch.float32,) * len(shapes),
                                layout.offsets, layout.n)
        self._to_wire = self._to_port = None
        if any(o is not None for o in orders):
            idx = np.concatenate([
                np.arange(off, off + int(np.prod(sh)), dtype=np.int64).reshape(sh)
                .transpose(o).reshape(-1) if o is not None
                else np.arange(off, off + int(np.prod(sh)), dtype=np.int64)
                for sh, off, o in zip(layout.shapes, layout.offsets, orders)])
            self._to_wire = torch.from_numpy(idx).to(self.device)
            self._to_port = torch.from_numpy(np.argsort(idx)).to(self.device)
        groups = self.chunks.groups
        q_base = np.cumsum([0] + [rows * width for width, rows, _ in groups])
        row_base = np.cumsum([0] + [rows for _, rows, _ in groups])
        self.q_bytes = int(q_base[-1])
        self._places = [(int(q_base[g] + row * width), int(row_base[g] + row), rows, width)
                        for g, row, rows, width in self.chunks.leaves]
        self.table = Int8Table.of([
            (qo, 4 * ro, rows, width, int(np.prod(sh, dtype=np.int64)), off)
            for (qo, ro, rows, width), sh, off in zip(self._places, shapes, layout.offsets)])
        self._received = None          # the int8 table of the last message decoded

    @classmethod
    def of(cls, layout, chunk: int, align: int, device, port: bool) -> "WirePlan":
        key = (repr(layout.treedef), layout.shapes, chunk, align, str(torch.device(device)),
               port)
        plan = cls._CACHE.get(key)
        if plan is None:
            plan = cls._CACHE[key] = cls(layout, chunk, align, device, port)
        return plan

    def to_wire(self, flat: torch.Tensor) -> torch.Tensor:
        return flat if self._to_wire is None else flat.index_select(0, self._to_wire)

    def to_port(self, flat: torch.Tensor) -> torch.Tensor:
        return flat if self._to_port is None else flat.index_select(0, self._to_port)

    def host_tree(self, flat: torch.Tensor):
        """The dense wire tree of a buffer: one gather into the wire's order,
        one copy to the host; numpy leaves in the reference's shapes."""
        from repro_torch.core.agg_engine import unravel
        return host_tree(unravel(self.to_wire(flat), self.wire))

    def encode(self, flat: torch.Tensor):
        """``(tree, q_all, s_all)``: the int8 wire tree of a buffer (each
        leaf a :class:`QuantizedTensor` at the reference's shape, whose
        arrays are views into ONE host copy), and the device q and scales
        it was copied from (for :meth:`dequantize`)."""
        from repro_torch.kernels import ops
        from repro_torch.tree import tree_unflatten
        qs, ss = zip(*[ops.quantize_int8(m) for m in self.chunks.pack(flat.detach())])
        q_all = torch.cat([q.reshape(-1) for q in qs])
        s_all = torch.cat(ss)
        host = torch.cat([q_all.view(torch.uint8), s_all.view(torch.uint8)]).cpu().numpy()
        hq, hs = host[: self.q_bytes].view(np.int8), host[self.q_bytes:].view(np.float32)
        leaves = [QuantizedTensor("int8", sh, {"q": hq[qo: qo + rows * width].reshape(rows, width),
                                               "scale": hs[ro: ro + rows]})
                  for (qo, ro, rows, width), sh in zip(self._places, self.wire.shapes)]
        return tree_unflatten(self.wire.treedef, leaves), q_all, s_all

    def decode(self, tree) -> torch.Tensor:
        """A received tree of this model (the wire's layout) as one fp32
        buffer in the wire's order on the plan's device: see
        :func:`decode_flat`.  A model's messages have the same geometry and
        payload offsets every round, so the last message's int8 table is
        kept and used again when the next one matches it."""
        flat, self._received = _decode(tree, self.wire, self.device, self._received)
        return flat

    def dequantize(self, q_all: torch.Tensor, s_all: torch.Tensor) -> torch.Tensor:
        """deQ of an :meth:`encode`, in this plan's buffer layout: one
        ``dequantize_int8`` launch into the wire's order, one gather back."""
        from repro_torch.kernels import ops
        out = torch.empty(self.layout.n, dtype=torch.float32, device=q_all.device)
        ops.dequantize_int8_grouped(self.table, q_all.view(torch.uint8),
                                    s_all.view(torch.uint8), out)
        return self.to_port(out)


def host_tree(tree: Any) -> Any:
    """A device tree (views of one fp32 buffer) as numpy leaves on the host:
    one copy of the buffer."""
    from repro_torch.core.agg_engine import ravel, tree_layout
    from repro_torch.tree import tree_unflatten
    layout = tree_layout(tree)
    host = ravel(tree).detach().to("cpu", copy=True).numpy()
    return tree_unflatten(layout.treedef, [
        host[o: o + int(np.prod(sh, dtype=np.int64))].reshape(sh)
        for sh, o in zip(layout.shapes, layout.offsets)])


def _as_device(span: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host byte span -> an owned uint8 tensor on ``device``: one copy."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # a frame's bytes are read-only
        host = torch.from_numpy(span)
    return host.clone() if device.type == "cpu" else host.to(device)


def _decode(tree, layout, device: torch.device, last=None):
    """``(flat, table)``: every leaf of a received tree decoded into ONE
    fp32 buffer on ``device`` at ``layout``'s offsets.  ``table`` is the
    message's int8 table with its key (payload offsets and leaf geometry);
    ``last``, a table from an earlier message, is used again where the key
    is the same."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import Int8Table
    leaves, arrays, geom = tree_leaves(tree), [], []
    if len(leaves) != len(layout.shapes):
        raise ValueError(f"a message of {len(leaves)} leaves for a model of "
                         f"{len(layout.shapes)}")
    for x, shape in zip(leaves, layout.shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"a leaf of shape {tuple(x.shape)} where the model has {shape}")
        if isinstance(x, QuantizedTensor):
            if x.codec != "int8":
                raise ValueError(f"unknown quantized-tensor codec {x.codec!r}")
            q, s = np.asarray(x.data["q"]), np.asarray(x.data["scale"])
            if q.dtype != np.int8 or q.ndim != 2 or s.dtype != np.float32 \
                    or s.shape != q.shape[:1]:
                raise ValueError(f"malformed int8 leaf: q {q.dtype} {q.shape}, "
                                 f"scale {s.dtype} {s.shape}")
            arrays += [q, s]
            geom.append(q.shape)
        elif isinstance(x, MaskedTensor):
            raise NotPorted("secure_agg", "a masked upload", "plaintext uploads")
        else:
            a = np.asarray(x)
            if a.dtype.kind != "f":
                raise ValueError(f"not a float leaf: {a.dtype}")
            arrays.append(a)
            geom.append(a.dtype.name)
    span, offsets = payload_span(arrays)
    key = (tuple(offsets), tuple(geom))
    if last is None or last[0] != key:
        it, entries, dense = iter(offsets), [], []
        for g, shape, out_off in zip(geom, layout.shapes, layout.offsets):
            size = int(np.prod(shape, dtype=np.int64))
            if isinstance(g, str):
                dense.append((out_off, next(it), size, np.dtype(g)))
            else:
                entries.append((next(it), next(it), g[0], g[1], size, out_off))
        last = (key, Int8Table.of(entries), dense)
    _, table, dense = last
    buf = _as_device(span, device)
    if (table.leaves == 0 and len(dense) == len(leaves) and span.nbytes == 4 * layout.n
            and all(dt == np.float32 and b == 4 * o for o, b, _, dt in dense)):
        return buf.view(torch.float32), last
    out = torch.empty(layout.n, dtype=torch.float32, device=device)
    ops.dequantize_int8_grouped(table, buf, buf, out)
    for out_off, b, size, dt in dense:
        src = buf[b: b + size * dt.itemsize]
        src = src if b % dt.itemsize == 0 else src.clone()
        out[out_off: out_off + size] = src.view(_TORCH_DTYPES[dt.name]).float()
    return out, last


def decode_flat(tree, *, device) -> Tuple[torch.Tensor, Any]:
    """``(flat, layout)``: every leaf of a received tree decoded into ONE
    fp32 buffer on ``device``, in flatten order at the leaves' logical
    shapes.  The arrays' bytes go to the device in one copy; every int8
    leaf is decoded by one ``dequantize_int8`` launch (its plain version
    on the CPU); an all-fp32 tree is the copied bytes themselves.  A
    model's messages are decoded through its :meth:`WirePlan.decode`,
    which keeps the table for the next round."""
    from repro_torch.core.agg_engine import tree_layout
    layout = tree_layout(tree)
    flat, _ = _decode(tree, layout, torch.device(device))
    return flat, layout


_TORCH_DTYPES = {"float16": torch.float16, "float32": torch.float32, "float64": torch.float64}


def decode_tree(tree: Any, *, device) -> Any:
    """Every leaf of a received tree on ``device`` (fp32 views of one
    buffer, at the leaves' logical shapes): see :func:`decode_flat`."""
    from repro_torch.core.agg_engine import unravel
    flat, layout = decode_flat(tree, device=device)
    return unravel(flat, layout)


def is_compressed(meta: Dict[str, Any]) -> bool:
    return meta.get("compression", "none") != "none"


def _decode_with(tree, meta, reference, plan: WirePlan, what: str):
    from repro_torch.core.agg_engine import ravel, unravel
    flat = plan.decode(tree)
    if meta.get("delta"):
        if reference is None:
            raise ValueError(f"delta {what} but no {'reference' if what == 'upload' else 'held'}"
                             f" global to decode against")
        flat = flat + ravel(reference)
    return unravel(flat, plan.wire)


def decode_upload(tree: Any, meta: Dict[str, Any], reference: Any = None, *,
                  plan: WirePlan) -> Any:
    """Server side of :meth:`UploadCompressor.encode`: the upload on the
    plan's device and, for a delta, ``+ reference`` (the global the site
    encoded against, in the wire's layout)."""
    return _decode_with(tree, meta, reference, plan, "upload")


def decode_download(tree: Any, meta: Dict[str, Any], reference: Any = None, *,
                    plan: WirePlan) -> Any:
    """Site side of :meth:`DownlinkCompressor.encode`: the download on the
    plan's device and, for a delta, ``+ reference`` (the site's held copy
    of its last decoded download, in the wire's layout)."""
    return _decode_with(tree, meta, reference, plan, "download")


class UploadCompressor:
    """One site's upload encoder: delta against the last pulled global, the
    error-feedback residual carried across rounds, and the codec.

    The site's trees are the port's (conv weights OIDHW) on its device;
    the payload is the reference's layout on the host (:class:`WirePlan`).
    The residual ``u - deQ(Q(u))`` is computed on the device from the
    device q and scales.  ``raw_bytes``/``encoded_bytes`` count fp32 and
    payload bytes."""

    def __init__(self, codec: Codec, error_feedback: bool = True):
        self.codec = codec
        self.error_feedback = error_feedback
        self.residual: Optional[torch.Tensor] = None     # [N], the port's layout
        self.raw_bytes = 0
        self.encoded_bytes = 0
        self.encodes = 0

    def plan(self, params_tree) -> WirePlan:
        from repro_torch.core.agg_engine import ravel, tree_layout
        dev = ravel(params_tree).device
        return WirePlan.of(tree_layout(params_tree), getattr(self.codec, "chunk", 1024),
                           align_for(dev), dev, port=True)

    def encode(self, params_tree: Any, reference: Any = None
               ) -> Tuple[Any, Dict[str, Any]]:
        """Encode one upload; returns ``(payload_tree, meta)``."""
        from repro_torch.core.agg_engine import ravel
        flat, plan = ravel(params_tree), self.plan(params_tree)
        if self.codec.name == "none":
            payload = plan.host_tree(flat)
            nb = tree_payload_nbytes(payload)
            self.raw_bytes += nb
            self.encoded_bytes += nb
            self.encodes += 1
            return payload, {"compression": "none", "delta": False}
        delta = reference is not None
        u = flat - ravel(reference) if delta else flat
        if self.error_feedback and self.residual is not None:
            u = u + self.residual
        enc, q_all, s_all = plan.encode(u)
        if self.error_feedback:
            self.residual = u - plan.dequantize(q_all, s_all)
        self.raw_bytes += 4 * u.numel()
        self.encoded_bytes += tree_payload_nbytes(enc)
        self.encodes += 1
        return enc, {"compression": self.codec.name, "delta": delta}


class DownlinkCompressor:
    """Server-side download encoder: per-site held references (what each
    site holds after decoding everything sent so far), each broadcast a
    quantized delta ``Q(g - held)`` against it, and ``held +=
    deQ(Q(g - held))`` on the device after each encode.  A site with no
    reference, an evicted one, or an ``acked_round`` that disagrees with
    the record gets the dense global (a bootstrap).  Trees are the wire's
    layout on the server's device."""

    def __init__(self, codec: Codec, error_feedback: bool = True):
        self.codec = codec
        self.error_feedback = error_feedback
        self._held: Dict[Any, list] = {}        # site -> [held_tree, round]
        self.raw_bytes = 0
        self.encoded_bytes = 0
        self.encodes = 0
        self.dense_sends = 0

    def encode(self, site: Any, global_tree: Any, round_index: int,
               acked_round: Optional[int] = None, host_tree: Any = None
               ) -> Tuple[Any, Dict[str, Any]]:
        """Encode the current global for ``site``; returns ``(payload_tree,
        meta)``.  ``host_tree`` is the dense host copy of the global where
        the caller already has one."""
        from repro_torch.core.agg_engine import ravel, tree_layout, unravel
        g = ravel(global_tree)
        layout = tree_layout(global_tree)
        plan = WirePlan.of(layout, getattr(self.codec, "chunk", 1024), align_for(g.device),
                           g.device, port=False)
        dense_tree = (lambda: host_tree if host_tree is not None else plan.host_tree(g))
        if self.codec.name == "none":
            self._held[site] = [global_tree, int(round_index)]
            return dense_tree(), {"compression": "none", "delta": False}
        st = self._held.get(site)
        dense = (st is None or acked_round is None or int(acked_round) != st[1])
        raw = 4 * g.numel()
        if dense:
            self._held[site] = [global_tree, int(round_index)]
            self.raw_bytes += raw
            self.encoded_bytes += raw
            self.encodes += 1
            self.dense_sends += 1
            return dense_tree(), {"compression": "none", "delta": False}
        held = ravel(st[0])
        enc, q_all, s_all = plan.encode(g - held)
        new_held = held + plan.dequantize(q_all, s_all) if self.error_feedback else g
        self._held[site] = [unravel(new_held, layout), int(round_index)]
        self.raw_bytes += raw
        self.encoded_bytes += tree_payload_nbytes(enc)
        self.encodes += 1
        return enc, {"compression": self.codec.name, "delta": True}

    def evict_stale(self, current_round: int, keep: int) -> None:
        """Drop held references of sites that have not downloaded within
        the ``keep`` most recent rounds; their next download is dense."""
        cutoff = int(current_round) - int(keep)
        for sid in [s for s, (_, hr) in self._held.items() if hr <= cutoff]:
            del self._held[sid]

    # -- checkpoint persistence hooks ----------------------------------------

    def held_sites(self):
        return sorted(self._held)

    def held_state(self, site):
        """``[held_tree, held_round]`` for ``site`` (or None)."""
        return self._held.get(site)

    def restore(self, site, held_tree, held_round: int, *, device) -> None:
        self._held[site] = [decode_tree(held_tree, device=device), int(held_round)]
