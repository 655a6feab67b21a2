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
the serving caches need, and the gradients of the three written out (the
reference has no backward kernel: XLA differentiates its jnp versions).
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


_FP8_MAX = 448.0


def quantize_fp8_ref(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., C, c] fp32 -> (float8_e4m3fn values [..., C, c], fp32 per-row
    scales [..., C]): each row's absmax maps to 448, e4m3's largest value,
    and the cast rounds to nearest even.  ``x / scale`` may land a hair
    above 448 (never past 464, where e4m3fn, which has no infinity, turns
    to NaN): the cast rounds it back to 448."""
    absmax = mat.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, _FP8_MAX), float(MIN_SCALE))
    return (mat / scale[..., None]).to(torch.float8_e4m3fn), scale


def quantize_dequantize_fp8_ref(mat: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn quantize -> dequantize round trip over [..., C, c] fp32:
    the reference's ``quantize_dequantize_fp8_ref`` (and its wire codec),
    bit for bit.  Plain PyTorch on every device: the reference has no
    kernel for it."""
    q, scale = quantize_fp8_ref(mat)
    return q.float() * scale[..., None]


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


def _seen(lq: int, lk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """[Lq, Lk] bool: True where the query (at position ``i + Lk - Lq``)
    sees the key."""
    q_pos = torch.arange(lq, device=device) + (lk - lq)
    k_pos = torch.arange(lk, device=device)
    ok = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def _scores(q, k, causal, window, scale=None):
    """(masked fp32 scores [B, Hq, Lq, Lk] at ``scale``, default D ** -0.5,
    the mask, k's heads repeated over the GQA group as a function)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv

    def per_q_head(t):
        return t.repeat_interleave(group, dim=1).float()

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), per_q_head(k)) * \
        (d ** -0.5 if scale is None else scale)
    ok = _seen(lq, lk, causal, window, q.device)
    return torch.where(ok, s, torch.full_like(s, NEG_INF)), ok, per_q_head


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, Lq, D]; k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's dtype.

    GQA (q head h reads kv head ``h // (Hq / Hkv)``), fp32 softmax, scale
    ``D ** -0.5`` unless ``scale`` is given.  The queries are the last Lq positions; a key at
    position j is seen by the query at position i if ``j <= i`` (causal)
    and ``j > i - window`` (a sliding window); other scores are -1e30."""
    s, _, per_q_head = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, per_q_head(v)).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` and each row's log-sum-exp of the masked,
    scaled scores (fp32 [B, Hq, Lq]): what the backward reads."""
    s, _, per_q_head = _scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, per_q_head(v)).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention_ref`, written out: with
    ``p = exp(s - lse)`` (0 where the masks hide a key), ``delta =
    rowsum(dout * out)``, ``dp = dout v^T`` and ``ds = p (dp - delta)``,

        dv = p^T dout,   dq = scale ds k,   dk = scale ds^T q,

    dk and dv summed over the q heads of each GQA group.  Returns (dq, dk,
    dv) in the dtypes of q, k, v.  The plain version of both instances of
    the backward kernel: bf16 inputs are read as fp32, delta is taken from
    the bf16 ``out`` as given, and the fp32 gradients are rounded to bf16
    at the end."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    s, ok, per_q_head = _scores(q, k, causal, window, scale)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    g = dout.float()
    delta = torch.sum(g * out.float(), dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", g, per_q_head(v)) - delta[..., None])
    scale = d ** -0.5 if scale is None else scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, per_q_head(k)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    group = hq // hkv
    dk = dk.reshape(b, hkv, group, lk, d).sum(2)
    dv = dv.reshape(b, hkv, group, lk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       u: torch.Tensor, dout: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None, rows: bool = False):
    """The gradient of :func:`rwkv6_scan_ref` (from S = 0), written out.

    With S_t the state after step t (S_{-1} = 0) and the adjoint G_t of
    S_t, G_{L-1} = ``dstate`` (0 if None) and
    G_{t-1} = diag(w_t) G_t + r_t dout_t^T:

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dout_t
        dk_t = G_t v_t + u * r_t (v_t . dout_t)
        dv_t = G_t^T k_t + (sum_i u_i r_t,i k_t,i) dout_t
        dw_t = rowsum(G_t * S_{t-1})
        du   = sum_t r_t * k_t (v_t . dout_t)

    Returns (dr, dk, dv, dw, du) in the dtypes of r, k, v, w, u; du is
    [H, D], or each batch row's share [B, H, D] with ``rows`` (what a
    per-example gradient needs: the batch rows are the examples)."""
    b, h, l, d = r.shape
    rr, kk, vv, ww, gg = (x.float() for x in (r, k, v, w, dout))
    uu = u.float()[None]
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    before = []
    for t in range(l):
        before.append(s)
        s = ww[:, :, t, :, None] * s + kk[:, :, t, :, None] * vv[:, :, t, None, :]
    g = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float())
    dr, dk, dv, dw = (torch.empty((b, h, l, d), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.zeros((b, h, d), dtype=torch.float32, device=r.device)
    for t in reversed(range(l)):
        r_t, k_t, v_t, w_t, g_t = (x[:, :, t] for x in (rr, kk, vv, ww, gg))
        vd = (v_t * g_t).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", before[t], g_t) + uu * k_t * vd
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", g, v_t) + uu * r_t * vd
        dv[:, :, t] = (torch.einsum("bhij,bhi->bhj", g, k_t)
                       + (uu * r_t * k_t).sum(-1, keepdim=True) * g_t)
        dw[:, :, t] = (g * before[t]).sum(-1)
        du = du + r_t * k_t * vd
        g = w_t[..., :, None] * g + r_t[..., :, None] * g_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            (du if rows else du.sum(0)).to(u.dtype))


def mamba_scan_bwd_ref(dt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                       x: torch.Tensor, log_a: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None, rows: bool = False):
    """The gradient of :func:`mamba_scan_ref`, written out.

    With a_t = exp(dt_t A) (A = -exp(log_a), so dA/dlog_a = A), s_t the
    state after step t (s_{-1} = 0) and g_t the adjoint of s_t: g starts
    at ``dstate`` (0 if None), each step back adds y_t's share,
    g_t += dy_t (x) C_t, and passes g_{t-1} = a_t * g_t on, and

        dC_t   = sum_i dy_t,i s_t,i          dB_t = sum_i g_t,i dt_t,i x_t,i
        dx_t   = dt_t sum_n g_t,n B_t,n
        ddt_t  = sum_n g_t,n (x_t B_t,n + A_n a_t,n s_{t-1},n)
        dlog_a = A * sum_t g_t dt_t a_t s_{t-1}

    Returns (ddt, dB, dC, dx, dlog_a) in the inputs' dtypes; dlog_a is
    [di, ds], or each batch row's share [B, di, ds] with ``rows``."""
    a = -torch.exp(log_a.float())
    bsz, l, di = dt.shape
    dd, bb, cc, xx, yy = (z.float() for z in (dt, b_mat, c_mat, x, dy))
    s = torch.zeros((bsz, di, log_a.shape[-1]), dtype=torch.float32, device=dt.device)
    states = [s]
    for t in range(l):
        s = (torch.exp(dd[:, t, :, None] * a) * s
             + (dd[:, t] * xx[:, t])[..., None] * bb[:, t, None, :])
        states.append(s)
    g = torch.zeros_like(s) if dstate is None else dstate.float()
    ddt, dx = torch.empty_like(dd), torch.empty_like(xx)
    db, dc = torch.empty_like(bb), torch.empty_like(cc)
    da = torch.zeros_like(s)
    for t in reversed(range(l)):
        dt_t, b_t, c_t, x_t, dy_t = (z[:, t] for z in (dd, bb, cc, xx, yy))
        g = g + dy_t[..., None] * c_t[:, None, :]
        dc[:, t] = torch.einsum("bi,bis->bs", dy_t, states[t + 1])
        db[:, t] = torch.einsum("bis,bi->bs", g, dt_t * x_t)
        gb = torch.einsum("bis,bs->bi", g, b_t)
        dec = torch.exp(dt_t[..., None] * a)
        gds = g * dec * states[t]
        dx[:, t] = gb * dt_t
        ddt[:, t] = gb * x_t + (gds * a).sum(-1)
        da = da + gds * dt_t[..., None]
        g = g * dec
    dlog_a = da * a
    return (ddt.to(dt.dtype), db.to(b_mat.dtype), dc.to(c_mat.dtype), dx.to(x.dtype),
            (dlog_a if rows else dlog_a.sum(0)).to(log_a.dtype))
