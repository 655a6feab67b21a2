"""The Mamba-1 selective scan and its gradient: the Hopper kernels' wrappers.

``mamba_scan(dt, b_mat, c_mat, x, log_a)`` over dt/x ``[B, L, di]``,
B/C ``[B, L, ds]`` and log_a ``[di, ds]``, all fp32, returns
``(y, state)``:

    A = -exp(log_a),  s <- exp(dt * A) * s + (dt * x) (x) B,  y = s . C

with s ``[B, di, ds]`` from 0; ``y`` is ``[B, L, di]`` and ``state`` the
final s, which the prefill hands to the decode cache (the reference's
TPU kernel returns only ``y``).  These are the Mamba module's own
layouts, so it calls the kernel without a transpose.

One CUDA kernel, ``csrc/mamba_scan.cu``, for ``ds <= 32``.  Asked for
them, it also writes the state before every ``CKPT_STEPS``-th step.

The gradient: where autograd needs one (grad mode on and an input that
requires grad, or a ``torch.func`` transform), the call goes through
:class:`MambaScan`, a ``torch.autograd.Function`` whose forward keeps
those checkpoints and whose backward is ``csrc/mamba_scan_bwd.cu``
(fp32, ``ds <= 32``: :func:`mamba_scan_bwd`), which walks the stages
last to first and recomputes each one's states from its checkpoint,
keeping each entry's decay in registers for the walk back (one exp an
entry), its inputs staged by a ``cp.async`` ring that runs backwards; dB
and dC, sums over every channel, are added from per-block partials by a
second kernel in a fixed order.  The final state's gradient starts the
adjoint.  Both Functions carry a ``vmap`` rule that folds the mapped dimension into B;
the kernel writes log_a's gradient per batch row and the Function sums
the rows, so that per-example DP-SGD gets each example's own.  The
reference has no backward kernel: XLA differentiates its jnp scan
(``models/mamba.py::selective_scan``).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain versions :func:`repro_torch.kernels.ref.mamba_scan_ref` and
``mamba_scan_bwd_ref``, CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_bwd_ref, mamba_scan_ref

NAME = "mamba_scan"
BWD_NAME = "mamba_scan_bwd"
MAX_STATE = 32                          # the kernels' widest template instance
CKPT_STEPS = 16                         # kSteps in both sources: steps a checkpoint
# the backward's instances: (largest d_state, threads a channel); a block has
# BWD_THREADS threads, or 32 a thread of a channel where that is more
BWD_SPLITS = ((4, 1), (8, 2), (16, 4), (32, 8))
BWD_THREADS = 128                       # kThreadsB in mamba_scan_bwd.cu
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 15 + [_I] * 4 + [_P]


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


def check_bwd_instance(dtype: torch.dtype, d_state: int) -> None:
    """Raise :class:`~repro_torch.NotPorted` (seam ``mamba_scan_bwd``) where
    the backward kernel has no instance for ``dtype`` and ``d_state``: it
    has fp32 at ``1 <= d_state <= 32``."""
    if dtype != torch.float32 or not 1 <= d_state <= MAX_STATE:
        from repro_torch import NotPorted
        raise NotPorted(BWD_NAME, f"a {dtype} gradient at d_state {d_state} on the card",
                        f"float32 at d_state 1..{MAX_STATE}")


def _stages(l: int) -> int:
    return -(-l // CKPT_STEPS)


def bwd_block_channels(d_state: int) -> int:
    """Channels a block of the backward's instance for ``d_state``: the
    channel blocks of its partials of dB and dC."""
    g = next(g for top, g in BWD_SPLITS if d_state <= top)
    return max(BWD_THREADS, 32 * g) // g


def mamba_scan_cuda(dt, b_mat, c_mat, x, log_a, with_ckpt: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream: ``(y, state)``,
    or ``(y, state, ckpt)`` with ``with_ckpt`` (ckpt ``[B, ceil(L /
    CKPT_STEPS), di, ds]`` fp32: the state before every ``CKPT_STEPS``-th
    step)."""
    _check(dt, b_mat, c_mat, x, log_a)
    build.require_cuda("mamba_scan_cuda", dt, b_mat, c_mat, x, log_a)
    bsz, l, di = dt.shape
    ds = log_a.shape[1]
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {ds} not in [1, {MAX_STATE}]")
    y = torch.empty_like(dt)
    state = torch.empty((bsz, di, ds), dtype=torch.float32, device=dt.device)
    ckpt = (torch.empty((bsz, _stages(l), di, ds), dtype=torch.float32, device=dt.device)
            if with_ckpt else None)
    if bsz * di:
        with torch.cuda.device(dt.device):
            build.launch(NAME, "mamba_scan_f32", _ARGS, dt.data_ptr(), b_mat.data_ptr(),
                         c_mat.data_ptr(), x.data_ptr(), log_a.data_ptr(), y.data_ptr(),
                         state.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(),
                         bsz, l, di, ds, build.stream())
    return (y, state, ckpt) if with_ckpt else (y, state)


def mamba_scan_bwd_cuda(dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate):
    """Launch the backward (its two kernels: the walk back, then dB and dC
    from the blocks' partials) on PyTorch's current stream; one launch
    counted.  Returns ``(ddt, dB, dC, dx, dlog_a)`` with dlog_a per batch
    row, ``[B, di, ds]``.  ``ckpt`` is the forward's
    (:func:`mamba_scan_cuda` with ``with_ckpt``); ``dstate`` the final
    state's gradient."""
    _check(dt, b_mat, c_mat, x, log_a)
    bsz, l, di = dt.shape
    ds = log_a.shape[1]
    check_bwd_instance(dt.dtype, ds)
    if (dy.shape != dt.shape or dstate.shape != (bsz, di, ds)
            or ckpt.shape != (bsz, _stages(l), di, ds)):
        raise ValueError(f"mamba_scan_bwd: dy {tuple(dy.shape)}, dstate "
                         f"{tuple(dstate.shape)} and ckpt {tuple(ckpt.shape)} do not fit dt "
                         f"{tuple(dt.shape)}")
    dy, dstate = dy.contiguous(), dstate.contiguous()
    build.require_cuda("mamba_scan_bwd_cuda", dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    dlog_a = torch.zeros((bsz, di, ds), dtype=torch.float32, device=dt.device)
    if bsz * di:
        blocks = -(-di // bwd_block_channels(ds))
        part_b, part_c = (torch.empty((blocks, bsz, l, ds), dtype=torch.float32,
                                      device=dt.device) for _ in range(2))
        with torch.cuda.device(dt.device):
            build.launch(BWD_NAME, "mamba_scan_bwd_f32", _BWD_ARGS,
                         *(t.data_ptr() for t in (dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate,
                                                  ddt, db, dc, dx, dlog_a, part_b, part_c)),
                         bsz, l, di, ds, build.stream())
    else:
        db.zero_()
        dc.zero_()
    return ddt, db, dc, dx, dlog_a


def _fwd_cuda(dt, b_mat, c_mat, x, log_a):
    return mamba_scan_cuda(dt, b_mat, c_mat, x, log_a, with_ckpt=True)


def _fwd_plain(dt, b_mat, c_mat, x, log_a):
    """The plain forward, with no checkpoints (``[B, 0, di, ds]``): its
    backward recomputes every state."""
    y, state = mamba_scan_ref(dt, b_mat, c_mat, x, log_a)
    bsz, _, di = dt.shape
    return y, state, state.new_empty((bsz, 0, di, log_a.shape[1]))


def _bwd_plain(dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate):
    return mamba_scan_bwd_ref(dt, b_mat, c_mat, x, log_a, dy, dstate, rows=True)


def mamba_scan_bwd(dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate):
    """(ddt, dB, dC, dx, dlog_a per batch row) of :func:`mamba_scan` from
    its inputs, its checkpoints and the gradients of ``y`` and the final
    state: the plain version on CPU (which ignores ``ckpt``), the kernel
    on CUDA."""
    return build.dispatch(BWD_NAME, dt.device, _bwd_plain, mamba_scan_bwd_cuda,
                          dt, b_mat, c_mat, x, log_a, ckpt, dy, dstate)


def _fwd(dt, b_mat, c_mat, x, log_a):
    """``(y, state, ckpt)`` for :class:`MambaScan`: the plain forward on
    CPU, the kernel with its checkpoints on CUDA."""
    return build.dispatch(NAME, dt.device, _fwd_plain, _fwd_cuda, dt, b_mat, c_mat, x, log_a)


MambaScan, MambaScanBackward = build.scan_functions("MambaScan", NAME, _fwd, mamba_scan_bwd,
                                                    shared=4)


def mamba_scan(dt, b_mat, c_mat, x, log_a) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, L, di], final state [B, di, ds] fp32): the plain version on
    CPU, the kernel on CUDA; differentiable through :class:`MambaScan`
    wherever autograd or a transform needs it (on the card at ``d_state``
    up to 32, else ``NotPorted``)."""
    _check(dt, b_mat, c_mat, x, log_a)
    if build.needs_grad(dt, b_mat, c_mat, x, log_a):
        if dt.device.type == "cuda":
            check_bwd_instance(dt.dtype, log_a.shape[1])   # before the forward runs
        y, state, _ = MambaScan.apply(dt, b_mat, c_mat, x, log_a)
        return y, state
    return build.dispatch(NAME, dt.device, mamba_scan_ref, mamba_scan_cuda,
                          dt, b_mat, c_mat, x, log_a)
