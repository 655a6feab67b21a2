"""The int8 wire codec, ported from ``repro/comms/compression.py``.

Uploads (and, with downlink compression, broadcasts) ride a codec seam.
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

Importing this module imports no kernel: the kernels import
:data:`MIN_SCALE` from here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import numpy as np
import torch

from repro_torch import NotPorted
from repro_torch.comms.codec import QuantizedTensor
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
