"""The Mamba-1 selective scan: the Hopper kernel's wrapper.

``mamba_scan(dt, b_mat, c_mat, x, log_a)`` over dt/x ``[B, L, di]``,
B/C ``[B, L, ds]`` and log_a ``[di, ds]``, all fp32, returns
``(y, state)``:

    A = -exp(log_a),  s <- exp(dt * A) * s + (dt * x) (x) B,  y = s . C

with s ``[B, di, ds]`` from 0; ``y`` is ``[B, L, di]`` and ``state`` the
final s, which the prefill hands to the decode cache (the reference's
TPU kernel returns only ``y``).  These are the Mamba module's own
layouts, so it calls the kernel without a transpose.

One CUDA kernel, ``csrc/mamba_scan.cu``, for ``ds <= 32``.  Dispatch is
by the tensors' device and nothing else: CPU tensors take the plain
version :func:`repro_torch.kernels.ref.mamba_scan_ref`, CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_ref

NAME = "mamba_scan"
MAX_STATE = 32                          # the kernel's widest template instance
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def _check(dt, b_mat, c_mat, x, log_a) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"mamba_scan: dt and x must share one [B, L, di] shape, got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    bsz, l, di = dt.shape
    if log_a.dim() != 2 or log_a.shape[0] != di:
        raise ValueError(f"mamba_scan: log_a must be [{di}, ds], got {tuple(log_a.shape)}")
    ds = log_a.shape[1]
    if b_mat.shape != (bsz, l, ds) or c_mat.shape != (bsz, l, ds):
        raise ValueError(f"mamba_scan: B and C must be [{bsz}, {l}, {ds}], got "
                         f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    if any(t.dtype != torch.float32 for t in (dt, b_mat, c_mat, x, log_a)):
        raise TypeError("mamba_scan: every input must be float32")
    if len({t.device for t in (dt, b_mat, c_mat, x, log_a)}) != 1:
        raise ValueError("mamba_scan: tensors on different devices")


def mamba_scan_cuda(dt, b_mat, c_mat, x, log_a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(dt, b_mat, c_mat, x, log_a)
    build.refuse_backward(NAME, dt, b_mat, c_mat, x, log_a)
    build.require_cuda("mamba_scan_cuda", dt, b_mat, c_mat, x, log_a)
    bsz, l, di = dt.shape
    ds = log_a.shape[1]
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {ds} not in [1, {MAX_STATE}]")
    y = torch.empty_like(dt)
    state = torch.empty((bsz, di, ds), dtype=torch.float32, device=dt.device)
    if bsz * di == 0:
        return y, state
    with torch.cuda.device(dt.device):
        build.launch(NAME, "mamba_scan_f32", _ARGS, dt.data_ptr(), b_mat.data_ptr(),
                     c_mat.data_ptr(), x.data_ptr(), log_a.data_ptr(), y.data_ptr(),
                     state.data_ptr(), bsz, l, di, ds, build.stream())
    return y, state


def mamba_scan(dt, b_mat, c_mat, x, log_a) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, L, di], final state [B, di, ds] fp32): the plain version on
    CPU, the kernel on CUDA.  The kernel has no backward yet: a CUDA call
    that autograd would differentiate raises ``NotPorted`` (seam
    ``mamba_scan_bwd``); the CPU trains through the plain version."""
    _check(dt, b_mat, c_mat, x, log_a)
    return build.dispatch(NAME, dt.device, mamba_scan_ref, mamba_scan_cuda,
                          dt, b_mat, c_mat, x, log_a)
