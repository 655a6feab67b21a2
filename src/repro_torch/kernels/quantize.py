"""Per-chunk int8 quantize and dequantize: the Hopper kernels' wrappers.

- ``quantize_int8(x)``: fp32 ``[C, c]`` -> (int8 ``[C, c]``, fp32 scales
  ``[C]``), with ``scale = max(absmax / 127, MIN_SCALE)`` per row and
  ``q = clip(rint(x / scale), -127, 127)`` (round half to even).
- ``dequantize_int8(q, scales)``: int8 ``[C, c]`` x ``[C]`` -> fp32.
- ``dequantize_int8_grouped(table, q_base, s_base, out)``: every int8 leaf
  of a message, described by an :class:`Int8Table`, into one flat fp32
  buffer in one launch (the same kernel; ``dequantize_int8`` of one matrix
  is its one-entry case).

All are bit-exact with the reference's numpy codec.  Dispatch is by the
tensors' device: CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref`, CUDA tensors launch
``csrc/quantize_int8.cu`` / ``csrc/dequantize_int8.cu`` or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comms.compression import MIN_SCALE
from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_int8_grouped_ref, dequantize_int8_ref,
                                     quantize_int8_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int64


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"quantize_int8: x must be float32 [C, c], "
                        f"got {x.dtype} {tuple(x.shape)}")


def quantize_int8_cuda(x: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check_x(x)
    build.require_cuda("quantize_int8_cuda", x)
    rows, c = x.shape
    q = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows * c == 0:
        return q, s
    with torch.cuda.device(x.device):
        build.launch("quantize_int8", "quantize_int8",
                     [_P, _P, _P, _I, _I, ctypes.c_float, _P],
                     x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, c,
                     float(MIN_SCALE), build.stream())
    return q, s


def quantize_int8(x: torch.Tensor):
    """[C, c] fp32 -> (int8 [C, c], fp32 [C]): the plain version on CPU,
    the kernel on CUDA."""
    _check_x(x)
    return build.dispatch("quantize_int8", x.device, quantize_int8_ref,
                          quantize_int8_cuda, x)


def _check_q(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"dequantize_int8: q must be int8 [C, c], "
                        f"got {q.dtype} {tuple(q.shape)}")
    if scales.dtype != torch.float32 or scales.shape != q.shape[:1]:
        raise TypeError(f"dequantize_int8: scales must be float32 [{q.shape[0]}], "
                        f"got {scales.dtype} {tuple(scales.shape)}")
    if scales.device != q.device:
        raise ValueError("dequantize_int8: q and scales on different devices")


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check_q(q, scales)
    build.require_cuda("dequantize_int8_cuda", q, scales)
    rows, c = q.shape
    out = torch.empty((rows, c), dtype=torch.float32, device=q.device)
    if rows * c == 0:
        return out
    with torch.cuda.device(q.device):
        build.launch("dequantize_int8", "dequantize_int8", [_P, _P, _P, _I, _I, _P],
                     q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, c,
                     build.stream())
    return out


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 [C, c] x fp32 [C] -> fp32 [C, c]: the plain version on CPU,
    the kernel on CUDA."""
    _check_q(q, scales)
    return build.dispatch("dequantize_int8", q.device, dequantize_int8_ref,
                          dequantize_int8_cuda, q, scales)


@dataclasses.dataclass
class Int8Table:
    """The leaf table of one message layout: int64 ``[leaves, 7]`` rows of
    (q offset, scale offset, rows, width, size, output offset, first row).
    Built and checked on the host once per layout; its device copy is
    cached, so a call copies nothing but the message itself.  Offsets are
    bytes into the two base buffers a call passes (one copied payload span
    for a received frame, or an encoder's q and scale buffers)."""

    host: np.ndarray
    total_rows: int
    q_extent: int          # bytes of q_base the table reads
    s_extent: int          # bytes of s_base
    out_extent: int        # fp32 elements of out it writes
    _dev: Dict[torch.device, torch.Tensor] = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, leaves: Sequence[Tuple[int, int, int, int, int, int]]) -> "Int8Table":
        """From ``(q_off, s_off, rows, width, size, out_off)`` a leaf; leaves
        of no rows are dropped.  Raises for a leaf whose size does not fit
        its rows (the kernel writes ``size`` values, the last row ragged)."""
        rows_done, table = 0, []
        for q_off, s_off, rows, width, size, out_off in leaves:
            if rows == 0:
                continue
            if width < 1 or not (rows - 1) * width < size <= rows * width:
                raise ValueError(f"int8 leaf of {rows} x {width} cannot hold {size} values")
            if min(q_off, s_off, out_off) < 0:
                raise ValueError("negative int8 leaf offset")
            table.append((q_off, s_off, rows, width, size, out_off, rows_done))
            rows_done += rows
        host = np.asarray(table, np.int64).reshape(-1, 7)
        ext = lambda col, n: int((host[:, col] + n).max()) if len(host) else 0  # noqa: E731
        return cls(host, rows_done, ext(0, host[:, 2] * host[:, 3]), ext(1, 4 * host[:, 2]),
                   ext(5, host[:, 4]))

    @property
    def leaves(self) -> int:
        return len(self.host)

    def nbytes(self) -> int:
        """Bytes the kernel moves: q and scales read once, the values written,
        the table read."""
        h = self.host
        return int((h[:, 2] * h[:, 3]).sum() + 4 * h[:, 2].sum() + 4 * h[:, 4].sum()
                   + h.nbytes)

    def on(self, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._dev[device] = t
        return t


def _check_grouped(table: Int8Table, q_base, s_base, out) -> None:
    for name, t, dtype in (("q_base", q_base, torch.uint8), ("s_base", s_base, torch.uint8),
                           ("out", out, torch.float32)):
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"dequantize_int8_grouped: {name} must be 1-D {dtype}, "
                            f"got {t.dtype} {tuple(t.shape)}")
    if len({q_base.device, s_base.device, out.device}) != 1:
        raise ValueError("dequantize_int8_grouped: tensors on different devices")
    if (q_base.numel() < table.q_extent or s_base.numel() < table.s_extent
            or out.numel() < table.out_extent):
        raise ValueError("dequantize_int8_grouped: buffers smaller than the table reaches")


def dequantize_int8_grouped_cuda(table: Int8Table, q_base: torch.Tensor,
                                 s_base: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the grouped kernel on PyTorch's current stream."""
    _check_grouped(table, q_base, s_base, out)
    build.require_cuda("dequantize_int8_grouped_cuda", q_base, s_base, out)
    if table.leaves == 0:
        return out
    dev_table = table.on(out.device)
    with torch.cuda.device(out.device):
        build.launch("dequantize_int8", "dequantize_int8_grouped",
                     [_P, _I, _I, _P, _P, _P, _P], dev_table.data_ptr(), table.leaves,
                     table.total_rows, q_base.data_ptr(), s_base.data_ptr(), out.data_ptr(),
                     build.stream())
    return out


def dequantize_int8_grouped(table: Int8Table, q_base: torch.Tensor, s_base: torch.Tensor,
                            out: torch.Tensor) -> torch.Tensor:
    """Every leaf of ``table`` into ``out`` (returned): the plain version on
    CPU, one launch of the kernel on CUDA."""
    _check_grouped(table, q_base, s_base, out)
    return build.dispatch("dequantize_int8_grouped", out.device, _grouped_ref,
                          dequantize_int8_grouped_cuda, table, q_base, s_base, out)


def _grouped_ref(table: Int8Table, q_base, s_base, out) -> torch.Tensor:
    return dequantize_int8_grouped_ref(torch.from_numpy(table.host), q_base, s_base, out)
