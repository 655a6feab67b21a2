"""The RWKV-6 WKV recurrence and its gradient: the Hopper kernels' wrappers.

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
steps copied asynchronously while the previous ones run.  Asked for
them, it also writes the state before every ``CKPT_STEPS``-th step.

The gradient: where autograd needs one (grad mode on and an input that
requires grad, or a ``torch.func`` transform), the call goes through
:class:`Rwkv6Scan`, a ``torch.autograd.Function`` whose forward keeps
those checkpoints and whose backward is ``csrc/rwkv6_scan_bwd.cu`` (fp32,
head dims 32 and 64: :func:`rwkv6_scan_bwd`), which walks the stages
last to first and recomputes each one's states from its checkpoint, 8
steps at a time in registers: a (batch, head)'s rows are split over a
thread-block cluster of D / 32 blocks, each block's share of dv sent to
the block that owns the column through distributed shared memory, and
no state goes to global memory.  The final state's gradient starts the
adjoint.  Both Functions carry a ``vmap`` rule that folds the mapped
dimension into B; the kernel writes u's gradient per batch row and the
Function sums the rows, so that
per-example DP-SGD (``torch.func.vmap(torch.func.grad(...))``) gets each
example's own.  The reference has no backward kernel: XLA differentiates
its jnp scan (``models/rwkv6.py::wkv_scan``).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain versions :func:`repro_torch.kernels.ref.rwkv6_scan_ref` and
``rwkv6_scan_bwd_ref``, CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref

NAME = "rwkv6_scan"
BWD_NAME = "rwkv6_scan_bwd"
HEAD_DIMS = (32, 64)                    # the kernel's template instances
BWD_HEAD_DIMS = (32, 64)                # the backward's (fp32 only)
CKPT_STEPS = 16                         # kSteps in both sources: steps a checkpoint
_ENTRY = {torch.float32: "rwkv6_scan_f32", torch.bfloat16: "rwkv6_scan_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 13 + [_I] * 4 + [_P]


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


def check_bwd_instance(dtype: torch.dtype, head_dim: int) -> None:
    """Raise :class:`~repro_torch.NotPorted` (seam ``rwkv6_scan_bwd``) where
    the backward kernel has no instance for ``dtype`` and ``head_dim``: it
    has fp32 at head dims 32 and 64."""
    if dtype != torch.float32 or head_dim not in BWD_HEAD_DIMS:
        from repro_torch import NotPorted
        raise NotPorted(BWD_NAME, f"a {dtype} gradient at head dim {head_dim} on the card",
                        f"float32 at head dims {BWD_HEAD_DIMS}")


def _stages(l: int) -> int:
    return -(-l // CKPT_STEPS)


def rwkv6_scan_cuda(r, k, v, w, u, with_ckpt: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream: ``(out, state)``,
    or ``(out, state, ckpt)`` with ``with_ckpt`` (ckpt ``[B, H, ceil(L /
    CKPT_STEPS), D, D]`` fp32: the state before every ``CKPT_STEPS``-th
    step)."""
    _check(r, k, v, w, u)
    u32 = u.float().contiguous()
    build.require_cuda("rwkv6_scan_cuda", r, k, v, w, u32)
    build.require_aligned("rwkv6_scan_cuda", r, k, v, w)
    b, h, l, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ckpt = (torch.empty((b, h, _stages(l), d, d), dtype=torch.float32, device=r.device)
            if with_ckpt else None)
    if b * h:
        with torch.cuda.device(r.device):
            build.launch(NAME, _ENTRY[r.dtype], _ARGS, r.data_ptr(), k.data_ptr(),
                         v.data_ptr(), w.data_ptr(), u32.data_ptr(), out.data_ptr(),
                         state.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(),
                         b, h, l, d, build.stream())
    return (out, state, ckpt) if with_ckpt else (out, state)


def rwkv6_scan_bwd_cuda(r, k, v, w, u, ckpt, dout, dstate):
    """Launch the backward kernel on PyTorch's current stream: ``(dr, dk,
    dv, dw, du)`` with du per batch row, ``[B, H, D]``.  ``ckpt`` is the
    forward's (:func:`rwkv6_scan_cuda` with ``with_ckpt``); ``dstate``
    the final state's gradient."""
    _check(r, k, v, w, u)
    check_bwd_instance(r.dtype, r.shape[-1])
    b, h, l, d = r.shape
    if (dout.shape != r.shape or dstate.shape != (b, h, d, d)
            or ckpt.shape != (b, h, _stages(l), d, d)):
        raise ValueError(f"rwkv6_scan_bwd: dout {tuple(dout.shape)}, dstate "
                         f"{tuple(dstate.shape)} and ckpt {tuple(ckpt.shape)} do not fit r "
                         f"{tuple(r.shape)}")
    # the kernel copies 16 bytes at a time: a gradient that arrives off a
    # 16-byte boundary (a view) is copied
    dout, dstate = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (dout.float().contiguous(), dstate.float().contiguous()))
    u32 = u.float().contiguous()
    build.require_cuda("rwkv6_scan_bwd_cuda", r, k, v, w, u32, ckpt, dout, dstate)
    build.require_aligned("rwkv6_scan_bwd_cuda", r, k, v, w, ckpt)
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.zeros((b, h, d), dtype=torch.float32, device=r.device)
    if b * h:
        with torch.cuda.device(r.device):
            build.launch(BWD_NAME, "rwkv6_scan_bwd_f32", _BWD_ARGS,
                         *(t.data_ptr() for t in (r, k, v, w, u32, ckpt, dout, dstate,
                                                  dr, dk, dv, dw, du)),
                         b, h, l, d, build.stream())
    return dr, dk, dv, dw, du


def _fwd_cuda(r, k, v, w, u):
    return rwkv6_scan_cuda(r, k, v, w, u, with_ckpt=True)


def _fwd_plain(r, k, v, w, u):
    """The plain forward, with no checkpoints (``[B, H, 0, D, D]``): its
    backward recomputes every state."""
    out, state = rwkv6_scan_ref(r, k, v, w, u)
    b, h, _, d = r.shape
    return out, state, state.new_empty((b, h, 0, d, d))


def _bwd_plain(r, k, v, w, u, ckpt, dout, dstate):
    return rwkv6_scan_bwd_ref(r, k, v, w, u, dout, dstate, rows=True)


def rwkv6_scan_bwd(r, k, v, w, u, ckpt, dout, dstate):
    """(dr, dk, dv, dw, du per batch row) of :func:`rwkv6_scan` from its
    inputs, its checkpoints and the gradients of ``out`` and the final
    state: the plain version on CPU (which ignores ``ckpt``), the kernel
    on CUDA."""
    return build.dispatch(BWD_NAME, r.device, _bwd_plain, rwkv6_scan_bwd_cuda,
                          r, k, v, w, u, ckpt, dout, dstate)


def _fwd(r, k, v, w, u):
    """``(out, state, ckpt)`` for :class:`Rwkv6Scan`: the plain forward on
    CPU, the kernel with its checkpoints on CUDA."""
    return build.dispatch(NAME, r.device, _fwd_plain, _fwd_cuda, r, k, v, w, u)


Rwkv6Scan, Rwkv6ScanBackward = build.scan_functions("Rwkv6Scan", NAME, _fwd, rwkv6_scan_bwd,
                                                    shared=4)


def rwkv6_scan(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, L, D], final state [B, H, D, D] fp32): the plain
    version on CPU, the kernel on CUDA; differentiable through
    :class:`Rwkv6Scan` wherever autograd or a transform needs it (on the
    card in fp32 at head dims 32 and 64, else ``NotPorted``)."""
    _check(r, k, v, w, u)
    if build.needs_grad(r, k, v, w, u):
        if r.device.type == "cuda":
            check_bwd_instance(r.dtype, r.shape[-1])   # before the forward runs
        out, state, _ = Rwkv6Scan.apply(r, k, v, w, u)
        return out, state
    return build.dispatch(NAME, r.device, rwkv6_scan_ref, rwkv6_scan_cuda, r, k, v, w, u)
