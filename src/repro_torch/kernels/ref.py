"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the oracle that ``chip_smoke.py``
holds each CUDA kernel against on the card.

The int8 codec is bit-exact with the reference's numpy encoder: the scale
is ``max(absmax / 127, MIN_SCALE)`` in fp32 and ``q = clip(rint(x /
scale), -127, 127)`` with round-half-to-even.  Every division here is a
tensor by a tensor: on CUDA, PyTorch turns a division by a Python scalar
into a multiplication by its reciprocal, which is not the IEEE quotient.

The trimmed mean sums its kept ranks one rank at a time in ascending
order, from +0.0, so that the kernel, which does the same in registers,
matches it bit for bit.
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


def trimmed_mean_ref(stacked: torch.Tensor, active: torch.Tensor, f: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the active rows of [S, N] -> [N] fp32.

    Inactive rows (``active > 0.5`` false) sort past every active value as
    +inf (NaN sorts last, as in ``jnp.sort``).  With ``k`` active rows the
    trim depth is ``fe = min(f, max(k - 1, 0) // 2)`` and the result is the
    unweighted mean of ranks ``[fe, k - fe)``; with ``k = 0`` it is 0.  The
    active count stays a tensor, so nothing here waits for the device."""
    x = stacked.float()
    act = active.to(x.device).float() > 0.5
    xs = torch.sort(torch.where(act[:, None], x, torch.full_like(x, float("inf"))),
                    dim=0).values
    k = act.sum(dtype=torch.int32)
    fe = torch.clamp(torch.clamp_min(k - 1, 0) // 2, max=f)
    total = torch.zeros_like(xs[0])
    for r in range(xs.shape[0]):
        keep = (fe <= r) & (r < k - fe)
        total = total + torch.where(keep, xs[r], torch.zeros_like(total))
    return total / torch.clamp_min(k - 2 * fe, 1).float()


def masked_median_ref(stacked: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the active rows: the trimmed mean at
    the deepest trim, ``f = S`` (the mean of the two middle ranks for an
    even active count)."""
    return trimmed_mean_ref(stacked, active, int(stacked.shape[0]))
