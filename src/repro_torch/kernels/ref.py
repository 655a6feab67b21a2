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

The token models' three kernels (flash attention, the WKV-6 scan, the
selective scan) have their plain versions at the end: ports of the
reference's oracles in ``repro/kernels/ref.py``, with the final states
the serving caches need.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def dequantize_int8_grouped_ref(table: torch.Tensor, q_base: torch.Tensor,
                                s_base: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Every int8 leaf of a message into the flat fp32 buffer ``out``.

    ``table`` is int64 [leaves, 7]: q offset (bytes into the uint8 buffer
    ``q_base``), scale offset (bytes into ``s_base``; a scale may sit at any
    byte offset), rows, width, size, output offset and first row.  Each
    leaf is :func:`dequantize_int8_ref` of its ``[rows, width]`` matrix, of
    which the first ``size`` values land at its output offset."""
    for q_off, s_off, rows, width, size, out_off, _ in table.tolist():
        q = q_base[q_off: q_off + rows * width].view(torch.int8).view(rows, width)
        s = s_base[s_off: s_off + 4 * rows].clone().view(torch.float32)
        out[out_off: out_off + size] = dequantize_int8_ref(q, s).reshape(-1)[:size]
    return out


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


# -- the token models' kernels ---------------------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, Lq, D]; k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's dtype.

    GQA (q head h reads kv head ``h // (Hq / Hkv)``), fp32 softmax, scale
    ``D ** -0.5``.  The queries are the last Lq positions; a key at
    position j is seen by the query at position i if ``j <= i`` (causal)
    and ``j > i - window`` (a sliding window); other scores are -1e30."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (d ** -0.5)
    q_pos = torch.arange(lq, device=q.device) + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)
    ok = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence.  r/k/v/w [B, H, L, D]; u [H, D].

    out_t = r_t . (S + u * k_t (x) v_t);  S <- w_t * S + k_t (x) v_t, the
    decay along the k index of S [B, H, D, D].  Returns (out in r's dtype,
    the final fp32 state); S starts at ``state`` or 0."""
    b, h, l, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    u32 = u.float()[None, :, :, None]
    outs = []
    for t in range(l):
        r_t, k_t, v_t, w_t = (x[:, :, t].float() for x in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + u32 * kv))
        s = w_t[..., :, None] * s + kv
    out = torch.stack(outs, dim=2) if outs else torch.zeros_like(r, dtype=torch.float32)
    return out.to(r.dtype), s


def mamba_scan_ref(dt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                   x: torch.Tensor, log_a: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan.  dt/x [B, L, di]; b/c [B, L, ds];
    log_a [di, ds].

    A = -exp(log_a);  s <- exp(dt * A) * s + (dt * x) (x) B;  y = s . C,
    s from 0.  Returns (y in dt's dtype, the final fp32 state [B, di, ds])."""
    a = -torch.exp(log_a.float())
    bsz, l, di = dt.shape
    s = torch.zeros((bsz, di, log_a.shape[-1]), dtype=torch.float32, device=dt.device)
    ys = []
    for t in range(l):
        dt_t, b_t, c_t, x_t = (z[:, t].float() for z in (dt, b_mat, c_mat, x))
        dec = torch.exp(dt_t[..., None] * a)
        s = dec * s + (dt_t * x_t)[..., None] * b_t[..., None, :]
        ys.append(torch.einsum("bis,bs->bi", s, c_t))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(dt, dtype=torch.float32)
    return y.to(dt.dtype), s
