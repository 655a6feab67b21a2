"""Causal GQA flash attention: the Hopper kernel's wrapper.

``flash_attention(q, k, v, causal=True, window=None)`` takes the
reference kernel's layout, q ``[B, Hq, Lq, D]`` and k/v ``[B, Hkv, Lk,
D]``, with ``Lq <= Lk`` (the queries are the last Lq positions), any
GQA group ``Hq / Hkv``, an optional sliding window (a key at position j
is seen from position i if ``j > i - window``) with or without the
causal mask, and returns ``[B, Hq, Lq, D]`` in q's dtype.  Softmax and
accumulation are fp32, scale ``D ** -0.5``, as the reference's kernel.
The attention module transposes its ``[B, L, H, D]`` projections to
this layout around the call.

One CUDA kernel, ``csrc/flash_attention.cu``, for fp32 and bf16 and
head dims 32, 64, 128 and 256: fp32 on the tensor cores as three TF32
products, bf16 as one bf16 product, the q heads of a GQA group packed
into one block's rows, K/V tiles staged asynchronously.  Dispatch is by
the tensors' device and nothing else: CPU tensors take the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`, CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128, 256)          # the kernel's template instances
# the kernel's tiles (kBlockM and kBlockN in csrc/flash_attention.cu): packed
# (query, head) rows a block, and keys a K/V stage, half of them a warp
BLOCK_ROWS = 64
BLOCK_KEYS = 32
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(q, k, v, window)
    build.require_cuda("flash_attention_cuda", q, k, v)
    build.require_aligned("flash_attention_cuda", q, k, v)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        build.launch(NAME, _ENTRY[q.dtype], _ARGS, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), b, hq, hkv, lq, lk, d,
                     int(causal), 0 if window is None else int(window), build.stream())
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """[B, Hq, Lq, D] x [B, Hkv, Lk, D]^2 -> [B, Hq, Lq, D]: the plain
    version on CPU, the kernel on CUDA."""
    _check(q, k, v, window)
    return build.dispatch(NAME, q.device, flash_attention_ref, flash_attention_cuda,
                          q, k, v, causal, window)
