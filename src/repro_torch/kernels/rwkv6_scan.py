"""The RWKV-6 WKV recurrence: the Hopper kernel's wrapper.

``rwkv6_scan(r, k, v, w, u)`` over r/k/v/w ``[B, H, L, D]`` (fp32 or
bf16, one dtype) and the bonus u ``[H, D]`` returns ``(out, state)``:

    out_t = r_t . (S + u * k_t (x) v_t),   S <- w_t * S + k_t (x) v_t

with S ``[B, H, D, D]`` from 0, ``out`` in r's dtype and the final
``state`` in fp32: the prefill hands it to the decode cache (the
reference's TPU kernel returns only ``out``).  The RWKV-6 module
transposes its ``[B, L, H, D]`` projections to this layout around the
call.

One CUDA kernel, ``csrc/rwkv6_scan.cu``, for head dims 32 and 64: a
block per (batch, head), each thread a 4 x 8 tile of S in registers,
the sum over rows deferred through shared memory, the inputs of 16
steps copied asynchronously while the previous ones run.  Dispatch is
by the tensors' device and nothing else: CPU tensors take the plain
version :func:`repro_torch.kernels.ref.rwkv6_scan_ref`, CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rwkv6_scan_ref

NAME = "rwkv6_scan"
HEAD_DIMS = (32, 64)                    # the kernel's template instances
_ENTRY = {torch.float32: "rwkv6_scan_f32", torch.bfloat16: "rwkv6_scan_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan: r, k, v, w must share one [B, H, L, D] shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    if u.shape != (r.shape[1], r.shape[3]):
        raise ValueError(f"rwkv6_scan: u must be [{r.shape[1]}, {r.shape[3]}], "
                         f"got {tuple(u.shape)}")
    if r.dtype not in _ENTRY or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan: r, k, v, w must all be float32 or bfloat16, got "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("rwkv6_scan: tensors on different devices")


def rwkv6_scan_cuda(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(r, k, v, w, u)
    build.refuse_backward(NAME, r, k, v, w, u)
    u32 = u.float().contiguous()
    build.require_cuda("rwkv6_scan_cuda", r, k, v, w, u32)
    build.require_aligned("rwkv6_scan_cuda", r, k, v, w)
    b, h, l, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, state
    with torch.cuda.device(r.device):
        build.launch(NAME, _ENTRY[r.dtype], _ARGS, r.data_ptr(), k.data_ptr(),
                     v.data_ptr(), w.data_ptr(), u32.data_ptr(), out.data_ptr(),
                     state.data_ptr(), b, h, l, d, build.stream())
    return out, state


def rwkv6_scan(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, L, D], final state [B, H, D, D] fp32): the plain
    version on CPU, the kernel on CUDA.  The kernel has no backward yet:
    a CUDA call that autograd would differentiate raises ``NotPorted``
    (seam ``rwkv6_scan_bwd``); the CPU trains through the plain version."""
    _check(r, k, v, w, u)
    return build.dispatch(NAME, r.device, rwkv6_scan_ref, rwkv6_scan_cuda, r, k, v, w, u)
