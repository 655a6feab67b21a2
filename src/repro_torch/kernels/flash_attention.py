"""Causal GQA flash attention and its gradient: the Hopper kernels' wrappers.

``flash_attention(q, k, v, causal=True, window=None, scale=None)`` takes
the reference kernel's layout, q ``[B, Hq, Lq, D]`` and k/v ``[B, Hkv, Lk,
D]``, with ``Lq <= Lk`` (the queries are the last Lq positions), any
GQA group ``Hq / Hkv``, an optional sliding window (a key at position j
is seen from position i if ``j > i - window``) with or without the
causal mask, and returns ``[B, Hq, Lq, D]`` in q's dtype.  Softmax and
accumulation are fp32, the scores scaled by ``scale`` (``D ** -0.5`` by
default, the reference kernel's) in fp32.
The attention module transposes its ``[B, L, H, D]`` projections to
this layout around the call.  DeepSeek-V2's MLA, whose q/k and v head
dims differ and whose scale is the q/k head dim's, reaches it padded
with zero columns to one of ``HEAD_DIMS``, passing its own scale
(``models/attention._padded_attention``).

One CUDA kernel, ``csrc/flash_attention.cu``, for fp32 and bf16 and
head dims 32, 64, 128 and 256: fp32 on the tensor cores as three TF32
products, bf16 as one bf16 product, the q heads of a GQA group packed
into one block's rows, K/V tiles staged asynchronously.  Asked for it,
the kernel also writes each row's log-sum-exp (``lse``, fp32 ``[B, Hq,
Lq]``); serving does not ask.

The gradient: where autograd needs one (grad mode on and an input that
requires grad, or a ``torch.func`` transform), the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function`` whose forward
keeps ``lse`` and whose backward is ``csrc/flash_attention_bwd.cu``
(fp32 and bf16, head dims 32, 64, 128 and 256: :func:`flash_attention_bwd`;
its five products on the tensor cores as three TF32 products, as the
fp32 forward's, bf16 tiles converted to fp32 as they are staged and the
gradients rounded to bf16 as they are written; at head dim 256 a cluster
of four blocks splits D).  Both
Functions carry a ``vmap`` rule that folds the mapped dimension into B,
so ``torch.func.vmap(torch.func.grad(...))`` (per-example DP-SGD) runs
the same kernels.  The reference has no backward kernel: XLA
differentiates its plain attention.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain versions (:func:`repro_torch.kernels.ref.flash_attention_ref`,
``flash_attention_lse_ref``, ``flash_attention_bwd_ref``), CUDA tensors
launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref)

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
HEAD_DIMS = (32, 64, 128, 256)          # the kernel's template instances
BWD_HEAD_DIMS = (32, 64, 128, 256)      # the backward's, fp32 and bf16
# the kernel's tiles (kBlockM and kBlockN in csrc/flash_attention.cu): packed
# (query, head) rows a block, and keys a K/V stage, half of them a warp
BLOCK_ROWS = 64
BLOCK_KEYS = 32
# the backward's tiles (kKeys and kQueries in csrc/flash_attention_bwd.cu):
# keys a dK/dV block and a dQ stage, queries a dQ block and a dK/dV stage;
# each warp takes 16 rows and half of a stage's columns
BWD_BLOCK_KEYS = 64
BWD_BLOCK_QUERIES = 64
# above head dim 128 (kSplitCols): a cluster of D / BWD_SPLIT_COLS blocks shares
# each tile, every block taking s and dp over its own BWD_SPLIT_COLS columns of
# D and writing those columns of the gradients; the partials of s and dp are
# added in fp32 in rank order
BWD_SPLIT_COLS = 64


def bwd_split_cols(head_dim: int) -> int:
    """The columns of D one block of the backward takes at ``head_dim``."""
    return BWD_SPLIT_COLS if head_dim > 128 else head_dim


def padded_head_dim(width: int) -> int:
    """The smallest of ``HEAD_DIMS`` that holds ``width`` columns: the
    instance a caller whose head dims differ or miss the instances (MLA's
    q/k and v) pads its tensors to.  Raises
    :class:`~repro_torch.NotPorted` above the widest instance."""
    for d in HEAD_DIMS:
        if d >= width:
            return d
    from repro_torch import NotPorted
    raise NotPorted(NAME, f"head dim {width}", f"up to {HEAD_DIMS[-1]}, the widest instance")

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _D, _P]
_BWD_ARGS = [_P] * 11 + [_I] * 8 + [_D, _P]


def _scale_arg(scale: Optional[float]) -> float:
    """The kernels' scale argument: 0 asks for D ** -0.5."""
    return 0.0 if scale is None else float(scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, Lq, D] and k, v "
                         f"[B, Hkv, Lk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, lq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head dim")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if lq > k.shape[2]:
        raise ValueError(f"flash_attention: Lq {lq} > Lk {k.shape[2]}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v on different devices")


def check_bwd_instance(dtype: torch.dtype, head_dim: int) -> None:
    """Raise :class:`~repro_torch.NotPorted` (seam ``flash_attention_bwd``)
    where the backward kernel has no instance for ``dtype`` and
    ``head_dim``: it has fp32 and bf16 at head dims 32, 64, 128 and 256."""
    if dtype not in _BWD_ENTRY or head_dim not in BWD_HEAD_DIMS:
        from repro_torch import NotPorted
        raise NotPorted(BWD_NAME, f"a {dtype} gradient at head dim {head_dim} on the card",
                        f"float32 and bfloat16 at head dims {BWD_HEAD_DIMS}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         with_lse: bool = False, scale: Optional[float] = None):
    """Launch the CUDA kernel on PyTorch's current stream: ``out``, or
    ``(out, lse)`` with ``with_lse``."""
    _check(q, k, v, window)
    build.require_cuda("flash_attention_cuda", q, k, v)
    build.require_aligned("flash_attention_cuda", q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel():
        with torch.cuda.device(q.device):
            build.launch(NAME, _ENTRY[q.dtype], _ARGS, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                         b, hq, hkv, lq, lk, d, int(causal),
                         0 if window is None else int(window), _scale_arg(scale),
                         build.stream())
    return (out, lse) if with_lse else out


def _out_cuda(q, k, v, causal, window, scale):
    return flash_attention_cuda(q, k, v, causal, window, scale=scale)


def _lse_cuda(q, k, v, causal, window, scale):
    return flash_attention_cuda(q, k, v, causal, window, with_lse=True, scale=scale)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, window: Optional[int] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward (its kernels: delta, dK/dV, above head dim 128
    the sum of the q heads' shares of dk and dv, dQ) on PyTorch's current
    stream; one launch counted.  fp32 or bf16 tensors (``lse`` fp32); the
    gradients in q's dtype."""
    _check(q, k, v, window)
    check_bwd_instance(q.dtype, q.shape[-1])
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: out and dout must be q's dtype and lse fp32")
    dout = dout.contiguous()
    if dout.data_ptr() % 16:                # the kernel stages rows 16 bytes at a time
        dout = dout.clone()
    build.require_cuda("flash_attention_bwd_cuda", q, k, v, out, lse, dout)
    build.require_aligned("flash_attention_bwd_cuda", q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    # above head dim 128 each q head's share of dk and dv, added in a fixed order
    part = (torch.empty((2, b, hq, lk, d), dtype=torch.float32, device=q.device)
            if bwd_split_cols(d) < d else None)
    with torch.cuda.device(q.device):
        build.launch(BWD_NAME, _BWD_ENTRY[q.dtype], _BWD_ARGS,
                     *(t.data_ptr() for t in (q, k, v, out, lse, dout, delta)),
                     0 if part is None else part.data_ptr(),
                     *(t.data_ptr() for t in (dq, dk, dv)),
                     b, hq, hkv, lq, lk, d, int(causal), 0 if window is None else int(window),
                     _scale_arg(scale), build.stream())
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: Optional[int] = None, scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output,
    its ``lse`` and the output's gradient: the plain version on CPU, the
    kernel on CUDA."""
    _check(q, k, v, window)
    return build.dispatch(BWD_NAME, q.device, flash_attention_bwd_ref,
                          flash_attention_bwd_cuda, q, k, v, out, lse, dout, causal, window,
                          scale)


class FlashAttentionBackward(torch.autograd.Function):
    """The backward kernel as a Function, so that a vmapped backward (the
    backward of a vmapped :class:`FlashAttention`) folds into one launch.
    It has no derivative of its own."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, causal, window, scale):
        return flash_attention_bwd(q, k, v, out, lse, dout, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention: no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, causal, window, scale):
        folded = build.fold(info, in_dims[:6], (q, k, v, out, lse, dout))
        grads = FlashAttentionBackward.apply(*folded, causal, window, scale)
        return tuple(build.unfold(info, g) for g in grads), (0, 0, 0)


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of the forward kernel; the gradient of ``out`` comes
    from the backward kernel (``lse`` is not differentiable)."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return build.dispatch(NAME, q.device, flash_attention_lse_ref, _lse_cuda,
                              q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, out, lse, dout, ctx.causal,
                                                  ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        out, lse = FlashAttention.apply(*build.fold(info, in_dims[:3], (q, k, v)), causal,
                                        window, scale)
        return (build.unfold(info, out), build.unfold(info, lse)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, Hq, Lq, D] x [B, Hkv, Lk, D]^2 -> [B, Hq, Lq, D]: the plain
    version on CPU, the kernel on CUDA; differentiable through
    :class:`FlashAttention` wherever autograd or a transform needs it.
    ``scale`` multiplies the scores (default ``D ** -0.5``)."""
    _check(q, k, v, window)
    if build.needs_grad(q, k, v):
        if q.device.type == "cuda":
            check_bwd_instance(q.dtype, q.shape[-1])  # before the forward runs
        return FlashAttention.apply(q, k, v, causal, window, scale)[0]
    return build.dispatch(NAME, q.device, flash_attention_ref, _out_cuda,
                          q, k, v, causal, window, scale)
