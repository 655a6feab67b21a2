"""Federated weight aggregation (paper Eq. 1): the Hopper kernel's wrapper.

``fedagg(stacked, weights)`` computes ``out = sum_s weights_s * stacked_s``
over a ``[S, N]`` buffer (fp32 or bf16) with fp32 weights ``[S]``; the
output has the input's dtype and is accumulated in fp32.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
the plain version (:func:`repro_torch.kernels.ref.fedagg_ref`); a CUDA
tensor launches ``csrc/fedagg.cu`` or raises.  The kernel's design and
bound are described in that source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fedagg_ref

NAME = "fedagg"
_ENTRY = {torch.float32: "fedagg_f32", torch.bfloat16: "fedagg_bf16"}
_FNS = {}


def _fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(build.load(NAME), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


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
    if stacked.device.type != "cuda":
        raise ValueError(f"fedagg_cuda: tensors must be on CUDA, got {stacked.device}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedagg_cuda: stacked and weights must be contiguous")
    s, n = stacked.shape
    out = torch.empty((n,), dtype=stacked.dtype, device=stacked.device)
    if n == 0:
        return out
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(stacked.dtype)(stacked.data_ptr(), weights.data_ptr(),
                                 out.data_ptr(), s, n, stream)
    if err != 0:
        raise RuntimeError(f"fedagg kernel launch failed: CUDA error {err}")
    build.count_launch(NAME)
    return out


def fedagg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[S, N] x [S] -> [N]: the plain version on CPU, the kernel on CUDA."""
    _check(stacked, weights)
    if stacked.device.type == "cpu":
        return fedagg_ref(stacked, weights)
    if stacked.device.type == "cuda":
        return fedagg_cuda(stacked, weights)
    raise ValueError(f"fedagg: no kernel for device {stacked.device}")
