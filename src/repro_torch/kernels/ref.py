"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the oracle that ``chip_smoke.py``
holds each CUDA kernel against on the card.

The int8 codec is bit-exact with the reference's numpy encoder: the scale
is ``max(absmax / 127, MIN_SCALE)`` in fp32 and ``q = clip(rint(x /
scale), -127, 127)`` with round-half-to-even.  Every division here is a
tensor by a tensor: on CUDA, PyTorch turns a division by a Python scalar
into a multiplication by its reciprocal, which is not the IEEE quotient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.comms.compression import MIN_SCALE

_QMAX = 127.0


def fedagg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted site aggregation: out = sum_s w_s * x_s.  stacked: [S, N]."""
    return (weights.float()[:, None] * stacked.float()).sum(0).to(stacked.dtype)


def _scales(mat: torch.Tensor) -> torch.Tensor:
    absmax = mat.abs().amax(dim=-1)
    return torch.clamp_min(absmax / torch.full_like(absmax, _QMAX), float(MIN_SCALE))


def quantize_int8_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, c] fp32 -> (int8 values [C, c], fp32 per-row scales [C])."""
    scale = _scales(x)
    q = torch.clamp(torch.round(x / scale[:, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 [C, c] x fp32 [C] -> fp32 [C, c]."""
    return q.float() * scales[:, None]


def fedagg_dequant_ref(q: torch.Tensor, scales: torch.Tensor, u: torch.Tensor,
                       weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize every site's upload and fold Eq. 1 over them:
    q [S, C, c] int8, scales [S, C], u [S, C, c] fp32 (the quantized input),
    weights [S] -> (g = sum_s w_s * deq_s [C, c], residual u - deq [S, C, c])."""
    deq = q.float() * scales[..., None]
    return (weights.float()[:, None, None] * deq).sum(0), u - deq


def dequant_install_ref(q: torch.Tensor, scales: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """Per-site install of a quantized delta: base + q * scale, [S, C, c]."""
    return base + q.float() * scales[..., None]


def quantize_dequantize_ref(mat: torch.Tensor) -> torch.Tensor:
    """int8 quantize -> dequantize round trip over [..., C, c] fp32."""
    scale = _scales(mat)[..., None]
    return torch.clamp(torch.round(mat / scale), -_QMAX, _QMAX) * scale
