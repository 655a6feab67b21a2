"""Per-chunk int8 quantize and dequantize: the Hopper kernels' wrappers.

- ``quantize_int8(x)``: fp32 ``[C, c]`` -> (int8 ``[C, c]``, fp32 scales
  ``[C]``), with ``scale = max(absmax / 127, MIN_SCALE)`` per row and
  ``q = clip(rint(x / scale), -127, 127)`` (round half to even).
- ``dequantize_int8(q, scales)``: int8 ``[C, c]`` x ``[C]`` -> fp32.

Both are bit-exact with the reference's numpy codec.  Dispatch is by the
tensors' device: CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref`, CUDA tensors launch
``csrc/quantize_int8.cu`` / ``csrc/dequantize_int8.cu`` or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.comms.compression import MIN_SCALE
from repro_torch.kernels import build
from repro_torch.kernels.ref import dequantize_int8_ref, quantize_int8_ref

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
