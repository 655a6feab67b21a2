"""Federated weight aggregation (paper Eq. 1) and its int8 variants: the
Hopper kernels' wrappers.

- ``fedagg(stacked, weights)``: ``out = sum_s weights_s * stacked_s`` over
  a ``[S, N]`` buffer (fp32 or bf16) with fp32 weights ``[S]``; the output
  has the input's dtype and is accumulated in fp32.
- ``fedagg_dequant(q, scales, u, weights)``: the compressed round's server
  step.  Every site's int8 upload ``q [S, C, c]`` with per-row scales
  ``[S, C]`` is dequantized and folded: ``g = sum_s w_s * deq_s [C, c]``,
  and the error-feedback residual ``u - deq [S, C, c]`` comes out of the
  same pass.
- ``dequant_install(q, scales, base)``: the downlink install
  ``base + deq [S, C, c]`` of every site's quantized broadcast delta.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain versions in :mod:`repro_torch.kernels.ref`; CUDA tensors launch
``csrc/<name>.cu`` or raise.  Each kernel's design and bound are
described in its source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequant_install_ref, fedagg_dequant_ref,
                                     fedagg_ref)

NAME = "fedagg"
_ENTRY = {torch.float32: "fedagg_f32", torch.bfloat16: "fedagg_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P, _P, _P, _I, _I, _P]


def _check(stacked: torch.Tensor, weights: torch.Tensor) -> None:
    if stacked.dim() != 2:
        raise ValueError(f"fedagg: stacked must be [S, N], got {tuple(stacked.shape)}")
    if stacked.dtype not in _ENTRY:
        raise TypeError(f"fedagg: stacked must be float32 or bfloat16, got {stacked.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"fedagg: weights must be float32, got {weights.dtype}")
    if weights.shape != (stacked.shape[0],):
        raise ValueError(f"fedagg: weights must be [{stacked.shape[0]}], "
                         f"got {tuple(weights.shape)}")
    if weights.device != stacked.device:
        raise ValueError(f"fedagg: weights on {weights.device}, "
                         f"stacked on {stacked.device}")


def fedagg_cuda(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(stacked, weights)
    build.require_cuda("fedagg_cuda", stacked, weights)
    s, n = stacked.shape
    out = torch.empty((n,), dtype=stacked.dtype, device=stacked.device)
    if n == 0:
        return out
    with torch.cuda.device(stacked.device):
        build.launch(NAME, _ENTRY[stacked.dtype], _ARGS, stacked.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), s, n, build.stream())
    return out


def fedagg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[S, N] x [S] -> [N]: the plain version on CPU, the kernel on CUDA."""
    _check(stacked, weights)
    return build.dispatch("fedagg", stacked.device, fedagg_ref, fedagg_cuda,
                          stacked, weights)


# -- int8 upload fold ---------------------------------------------------------


def _check_quantized(fn: str, q: torch.Tensor, scales: torch.Tensor,
                     dense: torch.Tensor) -> None:
    if q.dim() != 3 or q.dtype != torch.int8:
        raise TypeError(f"{fn}: q must be int8 [S, C, c], got {q.dtype} {tuple(q.shape)}")
    if scales.dtype != torch.float32 or scales.shape != q.shape[:2]:
        raise TypeError(f"{fn}: scales must be float32 {tuple(q.shape[:2])}, "
                        f"got {scales.dtype} {tuple(scales.shape)}")
    if dense.dtype != torch.float32 or dense.shape != q.shape:
        raise TypeError(f"{fn}: expected float32 {tuple(q.shape)}, "
                        f"got {dense.dtype} {tuple(dense.shape)}")
    if len({q.device, scales.device, dense.device}) != 1:
        raise ValueError(f"{fn}: tensors on different devices")


def _check_fold(q, scales, u, weights) -> None:
    _check_quantized("fedagg_dequant", q, scales, u)
    if weights.dtype != torch.float32 or weights.shape != (q.shape[0],):
        raise TypeError(f"fedagg_dequant: weights must be float32 [{q.shape[0]}], "
                        f"got {weights.dtype} {tuple(weights.shape)}")
    if weights.device != q.device:
        raise ValueError("fedagg_dequant: weights on another device")


def fedagg_dequant_cuda(q: torch.Tensor, scales: torch.Tensor, u: torch.Tensor,
                        weights: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check_fold(q, scales, u, weights)
    build.require_cuda("fedagg_dequant_cuda", q, scales, u, weights)
    s, rows, c = q.shape
    g = torch.empty((rows, c), dtype=torch.float32, device=q.device)
    r = torch.empty_like(u)
    if s * rows * c == 0:
        return g.zero_(), r
    with torch.cuda.device(q.device):
        build.launch("fedagg_dequant", "fedagg_dequant", [_P] * 6 + [_I] * 3 + [_P],
                     q.data_ptr(), scales.data_ptr(), u.data_ptr(),
                     weights.data_ptr(), g.data_ptr(), r.data_ptr(),
                     s, rows, c, build.stream())
    return g, r


def fedagg_dequant(q: torch.Tensor, scales: torch.Tensor, u: torch.Tensor,
                   weights: torch.Tensor):
    """-> (g [C, c], residual [S, C, c]): the plain version on CPU, the
    kernel on CUDA."""
    _check_fold(q, scales, u, weights)
    return build.dispatch("fedagg_dequant", q.device, fedagg_dequant_ref,
                          fedagg_dequant_cuda, q, scales, u, weights)


# -- int8 downlink install ----------------------------------------------------


def dequant_install_cuda(q: torch.Tensor, scales: torch.Tensor,
                         base: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check_quantized("dequant_install", q, scales, base)
    build.require_cuda("dequant_install_cuda", q, scales, base)
    s, rows, c = q.shape
    out = torch.empty_like(base)
    if s * rows * c == 0:
        return out
    with torch.cuda.device(q.device):
        build.launch("dequant_install", "dequant_install", [_P] * 4 + [_I] * 2 + [_P],
                     q.data_ptr(), scales.data_ptr(), base.data_ptr(),
                     out.data_ptr(), s * rows, c, build.stream())
    return out


def dequant_install(q: torch.Tensor, scales: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """-> base + deq [S, C, c]: the plain version on CPU, the kernel on CUDA."""
    _check_quantized("dequant_install", q, scales, base)
    return build.dispatch("dequant_install", q.device, dequant_install_ref,
                          dequant_install_cuda, q, scales, base)
