"""The wire codecs, ported from ``repro/comms/compression.py``.

Uploads (and, with downlink compression, broadcasts) ride a codec seam.
The socket deployment's halves are here too: :class:`UploadCompressor`
(a site's delta, error feedback and codec), :func:`decode_upload`,
:class:`DownlinkCompressor` (the server's per-site held references) and
:func:`decode_download`, all on the device of the trees they are given.
The codecs are the reference's:

- ``none``: the uncompressed model;
- ``int8``: per-chunk absmax int8, 4x smaller than fp32;
- ``fp8``: per-chunk absmax float8_e4m3fn (absmax to 448, round to
  nearest even), 4x smaller;
- ``topk`` (spec ``topk`` or ``topk-sparse``) and ``topk-fixed``: the
  largest-magnitude ``ceil(fraction * n)`` entries of each leaf, exact
  (a uint32 index and an fp32 value each).  A sparsifier's first upload
  of a run goes dense (``dense_bootstrap``).

Quantization granularity is a contiguous chunk of the flattened leaf (one
fp32 scale per chunk), laid out by :func:`chunk_geom`, the one geometry
rule that the wire codec and the round engine's on-device codec share, so
scales and byte counts agree by construction.  The int8 layout follows the
device, as the reference's follows its backend: a CUDA tensor is chunked
at ``align=128`` and quantized by the CUDA kernel, a CPU tensor at
``align=1`` by the kernel's plain version.  Either way the values are the
reference numpy encoder's, bit for bit; only the padding, and so the byte
count, differs.  fp8 is chunked at ``align=1`` everywhere, as the
reference chunks it (:meth:`Codec.align`), and is plain PyTorch on every
device, as the reference's jnp twin is: it has no kernel.

Top-k keeps, at the k-th magnitude, the entries of lower index in the
reference's element order (the rule of the reference's ``lax.top_k``
twin; its numpy codec breaks such ties arbitrarily), on the wire and in
the round engine alike (:class:`TopKPlan`).

A model crosses the wire in the reference's layout (conv weights DHWIO)
through a :class:`WirePlan`: a site gathers its OIDHW buffer into the
wire's element order at its edge, encodes it (one ``quantize_int8`` launch
per chunk width for int8) and copies it to the host once; every received
message is copied to the device in one transfer, every int8 leaf of it
decoded by ONE ``dequantize_int8`` launch, every fp8 leaf by a multiply
and every top-k leaf by a scatter on the device (:func:`decode_tree`).
``Int8Codec``, ``Fp8Codec`` and ``TopKCodec`` themselves encode an array
in the order they are given: a port model never goes to the wire through
them.

Importing this module imports no kernel: the kernels import
:data:`MIN_SCALE` from here.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.comms.codec import MaskedTensor, QuantizedTensor, e4m3_bits, payload_span
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
    """Wire payload bytes of a tree whose leaves are tensors, numpy arrays,
    :class:`QuantizedTensor` and/or :class:`MaskedTensor` (framing
    excluded)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, (QuantizedTensor, MaskedTensor)):
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

    def align(self, device: torch.device) -> int:
        """The chunk alignment of this codec's layout on ``device``."""
        return 1


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

    def align(self, device: torch.device) -> int:
        return align_for(device)

    def encode_array(self, arr) -> QuantizedTensor:
        """Quantize one leaf where it lies: the CUDA kernel for a CUDA
        tensor, the plain version for a CPU one.  The payload is host numpy."""
        from repro_torch.kernels import ops
        x = torch.as_tensor(arr).float()
        mat = _as_chunks(x.reshape(-1), self.chunk, align_for(x.device))
        q, s = ops.quantize_int8(mat.contiguous())
        return QuantizedTensor("int8", tuple(x.shape),
                               {"q": q.cpu().numpy(), "scale": s.cpu().numpy()})


@dataclasses.dataclass
class Fp8Codec(Codec):
    """Per-chunk absmax float8_e4m3fn: each chunk's absmax maps to 448, the
    cast rounds to nearest even; the same 4x as int8 on a log-spaced grid.
    Chunked at ``align=1`` on every device, as the reference chunks it."""

    chunk: int = 1024

    name = "fp8"

    def encode_array(self, arr) -> QuantizedTensor:
        """Quantize one leaf where it lies (plain PyTorch); the payload is
        host numpy, the values as :class:`~repro_torch.comms.codec.E4M3Bits`."""
        from repro_torch.kernels import ref
        x = torch.as_tensor(arr).float()
        q, s = ref.quantize_fp8_ref(_as_chunks(x.reshape(-1), self.chunk))
        return QuantizedTensor("fp8", tuple(x.shape),
                               {"q": e4m3_bits(q.view(torch.uint8).cpu().numpy()),
                                "scale": s.cpu().numpy()})


@dataclasses.dataclass
class TopKCodec(Codec):
    """Magnitude top-k per leaf: the largest-|x| ``ceil(fraction * n)``
    entries ride the wire exactly (uint32 index, fp32 value), the rest are
    zeroed and error feedback re-injects them later.  A sparsifier must not
    decimate a run's one full-model upload, so the bootstrap (no reference
    global yet) goes dense."""

    fraction: float = 0.1

    name = "topk"
    dense_bootstrap = True

    def encode_array(self, arr) -> QuantizedTensor:
        """Sparsify one leaf where it lies, by :class:`TopKPlan`'s rule."""
        x = torch.as_tensor(arr).float()
        flat = x.reshape(-1)
        keep = TopKPlan.of((flat.numel(),), self.fraction, flat.device).mask(flat)
        idx = keep.nonzero().reshape(-1)
        return QuantizedTensor("topk", tuple(x.shape),
                               {"idx": idx.to(torch.int32).cpu().numpy().view(np.uint32),
                                "val": flat[idx].cpu().numpy()})


@dataclasses.dataclass
class TopKFixedCodec(TopKCodec):
    """Top-k whose payload shapes depend on the leaf shapes alone (``k =
    ceil(fraction * n)`` a leaf); on the wire it encodes exactly as
    ``topk``.  The stacked transport runs it on the device
    (:mod:`repro_torch.core.round_engine`), where ``topk-sparse`` takes the
    host loop."""

    name = "topk-fixed"


def topk_count(fraction: float, n: int) -> int:
    """Entries kept of an ``n``-element leaf: ``max(1, ceil(fraction * n))``
    in float64, as the reference computes it; 0 for an empty leaf."""
    return max(1, int(np.ceil(fraction * n))) if n else 0


class TopKPlan:
    """The top-k selection over leaves of sizes ``sizes`` laid end to end
    in a ``[.., N]`` buffer.

    In each leaf (and each row of a stacked buffer) the ``k`` entries of
    largest magnitude are kept; at the k-th magnitude the entries of lower
    index win (``lax.top_k``'s rule), so the kept set is a function of the
    values alone, on every device.  One stable sort does it for every leaf:
    the key is the leaf's number, then the magnitude's bits, which order
    as the magnitudes do for non-negative floats, descending; the sort
    leaves each leaf in its own range, and the first ``k`` of the range
    are kept.  A leaf with ``k >= n`` is kept whole."""

    _CACHE: Dict[Any, "TopKPlan"] = {}

    def __init__(self, sizes: Tuple[int, ...], fraction: float, device: torch.device):
        sizes_np = np.asarray(sizes, np.int64)
        self.sizes = tuple(int(n) for n in sizes)
        self.counts = tuple(topk_count(fraction, n) for n in self.sizes)
        first = np.concatenate([[0], np.cumsum(sizes_np)[:-1]]).astype(np.int64)
        leaf_of = np.repeat(np.arange(len(sizes_np)), sizes_np)
        rank = np.arange(int(sizes_np.sum()), dtype=np.int64) - first[leaf_of]
        self.first = torch.from_numpy(first).to(device)
        self.leaf_of = torch.from_numpy(leaf_of).to(device)
        self._keep = torch.from_numpy(rank < np.asarray(self.counts, np.int64)[leaf_of]).to(device)

    @classmethod
    def of(cls, sizes: Tuple[int, ...], fraction: float, device) -> "TopKPlan":
        key = (tuple(sizes), float(fraction), str(torch.device(device)))
        plan = cls._CACHE.get(key)
        if plan is None:
            plan = cls._CACHE[key] = cls(sizes, fraction, torch.device(device))
        return plan

    @property
    def kept(self) -> int:
        """Entries kept a row."""
        return sum(self.counts)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        """[.., N] bool: the kept entries of every row of ``x``."""
        bits = x.abs().contiguous().view(torch.int32).to(torch.int64)
        key = self.leaf_of * (1 << 31) + ((1 << 31) - 1 - bits)
        order = torch.sort(key, dim=-1, stable=True).indices
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter_(
            -1, order, self._keep.expand(order.shape))

    def local(self, kept: torch.Tensor) -> torch.Tensor:
        """Each kept flat index's index within its own leaf."""
        return kept - self.first[self.leaf_of[kept]]


def _decode_int8(qt: QuantizedTensor, device) -> torch.Tensor:
    from repro_torch.kernels import ops
    q = torch.from_numpy(np.ascontiguousarray(qt.data["q"])).to(device)
    s = torch.from_numpy(np.asarray(qt.data["scale"], np.float32)).to(device)
    flat = ops.dequantize_int8(q, s).reshape(-1)
    size = int(np.prod(qt.shape, dtype=np.int64))
    return flat[:size].reshape(qt.shape)


def decode_array(leaf, *, device) -> torch.Tensor:
    """Dequantize one leaf onto ``device``: int8 launches the
    ``dequantize_int8`` kernel on a CUDA device (its plain version on the
    CPU); fp8 and top-k decode as :func:`decode_flat` does.  A plain array
    passes through (moved to ``device``)."""
    if isinstance(leaf, QuantizedTensor):
        if leaf.codec not in _DECODED:
            raise ValueError(f"unknown quantized-tensor codec {leaf.codec!r}")
        if leaf.codec == "int8":
            return _decode_int8(leaf, device)
        return decode_flat([leaf], device=device)[0].reshape(leaf.shape)
    return torch.as_tensor(leaf, device=device)


_DECODED = ("int8", "fp8", "topk")
_CODECS = {"none": NoneCodec, "int8": Int8Codec, "fp8": Fp8Codec,
           "topk": TopKCodec, "topk-sparse": TopKCodec,
           "topk-fixed": TopKFixedCodec}


def resolve_codec(spec: Union[str, Codec, None]) -> Codec:
    """``None``, a name or a :class:`Codec` -> a :class:`Codec`."""
    if spec is None:
        return NoneCodec()
    if isinstance(spec, Codec):
        return spec
    try:
        return _CODECS[spec]()
    except KeyError:
        raise KeyError(f"unknown compression codec {spec!r}; known: "
                       f"{sorted(_CODECS)}")


# ---------------------------------------------------------------------------
# Models on the wire: the reference's layout, decoded on the device
# ---------------------------------------------------------------------------


class WirePlan:
    """How one model layout crosses the wire, on one device.

    ``port=True``: the flat buffers are the port's (conv weights OIDHW) and
    :meth:`to_wire` / :meth:`to_port` gather between them and the wire's
    element order (leaves in flatten order, each in the reference's
    layout); ``port=False``: the buffers already hold the wire's order.
    :meth:`encode` quantizes a buffer to int8 leaf by leaf as the
    reference's codec does (one ``quantize_int8`` launch per chunk width),
    :meth:`dequantize` decodes that encode on the device in one launch,
    :meth:`encode_with` encodes with any codec, and :meth:`decode` decodes a
    received message of the model.  ``chunk`` and ``align`` are the
    codec's (:meth:`Codec.align`)."""

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
        """A ``[.., N]`` buffer in the wire's element order."""
        return flat if self._to_wire is None else flat.index_select(-1, self._to_wire)

    def to_port(self, flat: torch.Tensor) -> torch.Tensor:
        """A ``[.., N]`` buffer in the wire's order back in the plan's."""
        return flat if self._to_port is None else flat.index_select(-1, self._to_port)

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

    def encode_with(self, flat: torch.Tensor, codec: Codec) -> Tuple[Any, Callable[[], torch.Tensor]]:
        """``(tree, deq)``: the wire tree of a buffer under ``codec`` (int8,
        fp8 or top-k) and a function that gives ``deQ(Q(flat))`` in this
        plan's buffer layout (the error-feedback residual's other term)."""
        if codec.name == "int8":
            tree, q_all, s_all = self.encode(flat)
            return tree, lambda: self.dequantize(q_all, s_all)
        if codec.name == "fp8":
            return self.encode_fp8(flat)
        if codec.name in ("topk", "topk-fixed"):
            return self.encode_topk(flat, codec.fraction)
        raise ValueError(f"no wire encoder for codec {codec.name!r}")

    def encode_fp8(self, flat: torch.Tensor) -> Tuple[Any, Callable[[], torch.Tensor]]:
        """The fp8 wire tree of a buffer (each leaf's q as
        :class:`~repro_torch.comms.codec.E4M3Bits` and its scales, views into
        ONE host copy), quantized per chunk width on the device, and its
        ``deq`` (see :meth:`encode_with`)."""
        from repro_torch.kernels import ref
        from repro_torch.tree import tree_unflatten
        qs, ss = zip(*[ref.quantize_fp8_ref(m) for m in self.chunks.pack(flat.detach())])
        q_all = torch.cat([q.reshape(-1).view(torch.uint8) for q in qs])
        host = torch.cat([q_all, torch.cat(ss).view(torch.uint8)]).cpu().numpy()
        hq, hs = host[: self.q_bytes], host[self.q_bytes:].view(np.float32)
        leaves = [QuantizedTensor("fp8", sh, {
            "q": e4m3_bits(hq[qo: qo + rows * width].reshape(rows, width)),
            "scale": hs[ro: ro + rows]})
            for (qo, ro, rows, width), sh in zip(self._places, self.wire.shapes)]
        return (tree_unflatten(self.wire.treedef, leaves),
                lambda: self.chunks.unpack([q.float() * s[:, None] for q, s in zip(qs, ss)]))

    def topk_plan(self, fraction: float) -> "TopKPlan":
        """The top-k selection over this model's leaves in the wire's order."""
        return TopKPlan.of(tuple(int(np.prod(sh, dtype=np.int64)) for sh in self.wire.shapes),
                           fraction, self.device)

    def encode_topk(self, flat: torch.Tensor, fraction: float
                    ) -> Tuple[Any, Callable[[], torch.Tensor]]:
        """The top-k wire tree of a buffer (each leaf's ascending uint32
        indices and exact fp32 values, views into ONE host copy), selected
        in the wire's element order by :class:`TopKPlan`, and its ``deq``
        (see :meth:`encode_with`)."""
        from repro_torch.tree import tree_unflatten
        tp = self.topk_plan(fraction)
        w = self.to_wire(flat.detach())
        keep = tp.mask(w)
        kept = keep.nonzero().reshape(-1)                   # ascending
        vals = w.index_select(0, kept)
        idx = tp.local(kept).to(torch.int32)
        host = torch.cat([idx.view(torch.uint8), vals.view(torch.uint8)]).cpu().numpy()
        hi, hv = host[: 4 * kept.numel()].view(np.uint32), host[4 * kept.numel():].view(np.float32)
        bounds = np.cumsum((0,) + tp.counts)
        leaves = [QuantizedTensor("topk", sh, {"idx": hi[a:b], "val": hv[a:b]})
                  for sh, a, b in zip(self.wire.shapes, bounds[:-1], bounds[1:])]
        return (tree_unflatten(self.wire.treedef, leaves),
                lambda: self.to_port(torch.where(keep, w, torch.zeros_like(w))))


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


def _typed(buf: torch.Tensor, offset: int, count: int, dtype: torch.dtype) -> torch.Tensor:
    """``count`` values of ``dtype`` at byte ``offset`` of a uint8 buffer
    (copied first when the offset is not a multiple of the item size)."""
    size = torch.empty((), dtype=dtype).element_size()
    src = buf[offset: offset + count * size]
    return (src if offset % size == 0 else src.clone()).view(dtype)


def _leaf_arrays(x) -> Tuple[list, tuple]:
    """``(arrays, geometry)`` of one received leaf, checked: the arrays in
    the order :func:`_decode` reads them."""
    if isinstance(x, QuantizedTensor):
        if x.codec in ("int8", "fp8"):
            q, s = np.asarray(x.data["q"]), np.asarray(x.data["scale"])
            if x.codec == "fp8":
                q = e4m3_bits(q)
            want = np.int8 if x.codec == "int8" else np.uint8
            if q.dtype != want or q.ndim != 2 or s.dtype != np.float32 \
                    or s.shape != q.shape[:1]:
                raise ValueError(f"malformed {x.codec} leaf: q {q.dtype} {q.shape}, "
                                 f"scale {s.dtype} {s.shape}")
            return [q, s], (x.codec,) + q.shape
        if x.codec == "topk":
            idx, val = np.asarray(x.data["idx"]), np.asarray(x.data["val"])
            size = int(np.prod(x.shape, dtype=np.int64))
            if idx.dtype != np.uint32 or val.dtype != np.float32 or idx.ndim != 1 \
                    or idx.shape != val.shape or (idx.size and int(idx.max()) >= size):
                raise ValueError(f"malformed topk leaf: idx {idx.dtype} {idx.shape}, "
                                 f"val {val.dtype} {val.shape} for {size} entries")
            return [idx, val], ("topk", idx.size)
        raise ValueError(f"unknown quantized-tensor codec {x.codec!r}")
    if isinstance(x, MaskedTensor):
        # masked words fold as integers (privacy.secure_agg), never decode
        raise ValueError("a masked leaf in a plaintext message")
    a = np.asarray(x)
    if a.dtype.kind != "f":
        raise ValueError(f"not a float leaf: {a.dtype}")
    return [a], ("dense", a.dtype.name)


def _decode(tree, layout, device: torch.device, last=None):
    """``(flat, table)``: every leaf of a received tree decoded into ONE
    fp32 buffer on ``device`` at ``layout``'s offsets.  ``table`` is the
    message's decode table with its key (payload offsets and leaf
    geometry); ``last``, a table from an earlier message, is used again
    where the key is the same.  int8 leaves decode in one grouped
    ``dequantize_int8`` launch, fp8 leaves as ``q * scale`` and top-k leaves
    by a scatter into zeros, all on the device."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import Int8Table
    leaves, arrays, geom = tree_leaves(tree), [], []
    if len(leaves) != len(layout.shapes):
        raise ValueError(f"a message of {len(leaves)} leaves for a model of "
                         f"{len(layout.shapes)}")
    for x, shape in zip(leaves, layout.shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"a leaf of shape {tuple(x.shape)} where the model has {shape}")
        parts, g = _leaf_arrays(x)
        arrays += parts
        geom.append(g)
    span, offsets = payload_span(arrays)
    key = (tuple(offsets), tuple(geom))
    if last is None or last[0] != key:
        it, entries, dense, fp8, topk = iter(offsets), [], [], [], []
        for g, shape, out_off in zip(geom, layout.shapes, layout.offsets):
            size = int(np.prod(shape, dtype=np.int64))
            if g[0] == "dense":
                dense.append((out_off, next(it), size, np.dtype(g[1])))
            elif g[0] == "topk":
                topk.append((next(it), next(it), g[1], size, out_off))
            else:
                (entries if g[0] == "int8" else fp8).append(
                    (next(it), next(it), g[1], g[2], size, out_off))
        last = (key, Int8Table.of(entries), dense, fp8, topk)
    _, table, dense, fp8, topk = last
    buf = _as_device(span, device)
    if (table.leaves == 0 and not fp8 and not topk and len(dense) == len(leaves)
            and span.nbytes == 4 * layout.n
            and all(dt == np.float32 and b == 4 * o for o, b, _, dt in dense)):
        return buf.view(torch.float32), last
    out = torch.empty(layout.n, dtype=torch.float32, device=device)
    ops.dequantize_int8_grouped(table, buf, buf, out)
    for out_off, b, size, dt in dense:
        out[out_off: out_off + size] = _typed(buf, b, size, _TORCH_DTYPES[dt.name]).float()
    for q_off, s_off, rows, width, size, out_off in fp8:
        q = buf[q_off: q_off + rows * width].view(torch.float8_e4m3fn).view(rows, width)
        deq = q.float() * _typed(buf, s_off, rows, torch.float32)[:, None]
        out[out_off: out_off + size] = deq.reshape(-1)[:size]
    for i_off, v_off, k, size, out_off in topk:
        seg = out[out_off: out_off + size].zero_()
        seg[_typed(buf, i_off, k, torch.int32).long()] = _typed(buf, v_off, k, torch.float32)
    return out, last


def decode_flat(tree, *, device) -> Tuple[torch.Tensor, Any]:
    """``(flat, layout)``: every leaf of a received tree decoded into ONE
    fp32 buffer on ``device``, in flatten order at the leaves' logical
    shapes.  The arrays' bytes go to the device in one copy; every int8
    leaf is decoded by one ``dequantize_int8`` launch (its plain version
    on the CPU), the fp8 and top-k leaves by plain PyTorch on the device;
    an all-fp32 tree is the copied bytes themselves.  A
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

    The site's trees are the port's (conv weights OIDHW) on its device
    (``port=False``: trees already in the wire's layout, as a pod leader's
    partials are); the payload is the reference's layout on the host
    (:class:`WirePlan`).  The residual ``u - deQ(Q(u))`` is computed on the
    device.  A sparsifier's upload without a reference (the bootstrap) goes
    dense, with meta ``compression: "none"``, and sets no residual.
    ``raw_bytes``/``encoded_bytes`` count fp32 and payload bytes."""

    def __init__(self, codec: Codec, error_feedback: bool = True, port: bool = True):
        self.codec = codec
        self.error_feedback = error_feedback
        self.port = port
        self.residual: Optional[torch.Tensor] = None     # [N], the trees' layout
        self.raw_bytes = 0
        self.encoded_bytes = 0
        self.encodes = 0

    def plan(self, params_tree) -> WirePlan:
        from repro_torch.core.agg_engine import ravel, tree_layout
        dev = ravel(params_tree).device
        return WirePlan.of(tree_layout(params_tree), getattr(self.codec, "chunk", 1024),
                           self.codec.align(dev), dev, port=self.port)

    def encode(self, params_tree: Any, reference: Any = None
               ) -> Tuple[Any, Dict[str, Any]]:
        """Encode one upload; returns ``(payload_tree, meta)``."""
        from repro_torch.core.agg_engine import ravel
        flat, plan = ravel(params_tree), self.plan(params_tree)
        delta = reference is not None
        if self.codec.name == "none" or (
                not delta and getattr(self.codec, "dense_bootstrap", False)):
            payload = plan.host_tree(flat)
            nb = tree_payload_nbytes(payload)
            self.raw_bytes += nb
            self.encoded_bytes += nb
            self.encodes += 1
            return payload, {"compression": "none", "delta": False}
        u = flat - ravel(reference) if delta else flat
        if self.error_feedback and self.residual is not None:
            u = u + self.residual
        enc, deq = plan.encode_with(u, self.codec)
        if self.error_feedback:
            self.residual = u - deq()
        self.raw_bytes += 4 * u.numel()
        self.encoded_bytes += tree_payload_nbytes(enc)
        self.encodes += 1
        return enc, {"compression": self.codec.name, "delta": delta}

    def encode_against(self, params_tree: Any, reference: Any, base_round: int,
                       upload_round: int) -> Tuple[Any, Dict[str, Any]]:
        """An edge's upload for server round ``upload_round``: a delta
        against ``reference``, the global of server round ``base_round``,
        or dense once ``upload_round`` is ``KEEP_GLOBALS_DEFAULT`` or more
        past it (the server no longer keeps that global to decode
        against).  The meta carries ``base_round`` (0 for a dense upload)."""
        if reference is not None and upload_round - base_round >= KEEP_GLOBALS_DEFAULT:
            reference = None
        payload, meta = self.encode(params_tree, reference)
        meta["base_round"] = base_round if reference is not None else 0
        return payload, meta


def edge_rounds(buffered: bool, r: int, base_round: int) -> Tuple[int, int]:
    """``(upload_round, want)`` of an edge (a site, or a pod leader) in loop
    round ``r`` whose last pulled global is server round ``base_round``: a
    sync server's round ``r + 1`` both ways; under a buffered scheduler the
    upload carries the round after that pull (FedBuff's staleness anchor)
    and the pull takes whatever global is newest (``want = 0``)."""
    return (base_round + 1, 0) if buffered else (r + 1, r + 1)


class GlobalPull:
    """An edge's downloads of the global.  With a compressed downlink it
    keeps the decode reference (its last decoded download: the wire's
    layout on ``plan``'s device) and the round it acknowledges, so the
    server can send the next download as a delta.  ``plan`` may be None:
    it is then built from the first download, in the wire's layout on
    ``device``."""

    def __init__(self, down: bool, plan: Optional[WirePlan] = None, chunk: int = 1024,
                 device=None):
        self.down, self.plan, self.chunk, self.device = down, plan, chunk, device
        self.ref: Any = None
        self.acked: Optional[int] = None

    def pull(self, peer, addr, want: int) -> Tuple[Any, Optional[int]]:
        """``(global, server round)``: the decoded tree under a compressed
        downlink, else the payload as received; ``(None, None)`` while the
        server has no global (a buffered server before its first fold)."""
        g, meta = peer.download(addr, want, with_meta=True, down=self.down,
                                acked_round=self.acked)
        if g is None:
            return None, None
        if self.down:
            if self.plan is None:
                from repro_torch.core.agg_engine import tree_layout
                dev = torch.device(self.device)
                self.plan = WirePlan.of(tree_layout(g), self.chunk, align_for(dev), dev,
                                        port=False)
            g = self.ref = decode_download(g, meta, self.ref, plan=self.plan)
            self.acked = int(meta["round"])
        return g, int(meta["round"])


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
        plan = WirePlan.of(layout, getattr(self.codec, "chunk", 1024),
                           self.codec.align(g.device), g.device, port=False)
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
        enc, deq = plan.encode_with(g - held, self.codec)
        new_held = held + deq() if self.error_feedback else g
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
