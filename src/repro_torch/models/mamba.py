"""Mamba (S6) selective-scan mixer of Jamba's non-attention layers, ported
from ``repro/models/mamba.py``.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t        (per channel)
    y_t = C_t . h_t + D * x_t

State: [B, d_inner, d_state].  The prefill (:func:`mamba_apply`) runs the
scan through the selective-scan kernel (``kernels.mamba_scan``), which
also returns the final state for the decode cache; the reference computes
the same scan with a chunked ``lax.scan``.  Decode is one plain step
(:func:`discretize` and one update) with a rolling conv window.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import dense_init, normal, uniform


def _dims(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank if m.dt_rank is not None else math.ceil(cfg.d_model / 16)
    return m, d_inner, dt_rank


def mamba_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    m, d_inner, dt_rank = _dims(cfg)
    # S4D-real initialization for A
    a_init = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, cfg.d_model, 2 * d_inner, device, dtype),   # x and gate z
        "conv_w": normal(gen, (m.d_conv, d_inner), 0.1, device, dtype),
        "conv_b": torch.zeros((d_inner,), device=device, dtype=dtype),
        "w_bcdt": dense_init(gen, d_inner, 2 * m.d_state + dt_rank, device, dtype),
        "w_dt": dense_init(gen, dt_rank, d_inner, device, dtype),
        "dt_bias": uniform(gen, (d_inner,), -4.6, -2.3, device, dtype),
        "log_a": torch.log(a_init).expand(d_inner, m.d_state).contiguous(),  # fp32
        "d_skip": torch.ones((d_inner,), device=device, dtype=dtype),
        "w_out": dense_init(gen, d_inner, cfg.d_model, device, dtype),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            last_window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x [B, L, C]; w [K, C]; ``last_window`` is the
    previous segment's trailing K-1 inputs (stateful decode)."""
    k = w.shape[0]
    pad = torch.zeros_like(x[:, : k - 1]) if last_window is None else last_window
    xp = torch.cat([pad, x], dim=1)                                       # [B, L+K-1, C]
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _ssm_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    """Per-token SSM inputs (dt, B, C) of x [B, L, d_inner]."""
    m, _, _ = _dims(cfg)
    bcdt = x @ params["w_bcdt"]
    b_mat = bcdt[..., : m.d_state]
    c_mat = bcdt[..., m.d_state: 2 * m.d_state]
    dt = F.softplus(bcdt[..., 2 * m.d_state:] @ params["w_dt"]
                    + params["dt_bias"].to(x.dtype))                      # [B, L, d_inner]
    return dt, b_mat, c_mat


def discretize(dt: torch.Tensor, b_mat: torch.Tensor, x: torch.Tensor, log_a: torch.Tensor):
    """(decay, drive) of a token block. dt/x [..., di]; b_mat [..., ds]."""
    a = -torch.exp(log_a)                                                 # [di, ds]
    decay = torch.exp(dt.float()[..., None] * a)
    drive = (dt.float() * x.float())[..., None] * b_mat.float()[..., None, :]
    return decay, drive


def mamba_apply(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Mamba mixer (prefill); returns (y, cache or None)."""
    m, d_inner, _ = _dims(cfg)
    b, l, _ = x.shape
    xz = x @ params["w_in"]
    xin, z = xz[..., :d_inner], xz[..., d_inner:]
    xc = F.silu(_conv1d(xin, params["conv_w"], params["conv_b"]))
    dt, b_mat, c_mat = _ssm_inputs(params, xc, cfg)
    y, state = mamba_scan(dt.float().contiguous(), b_mat.float().contiguous(),
                          c_mat.float().contiguous(), xc.float().contiguous(),
                          params["log_a"].float())
    y = y.to(x.dtype) + params["d_skip"].to(x.dtype) * xc
    y = (y * F.silu(z)) @ params["w_out"]
    if not return_cache:
        return y, None
    if l >= m.d_conv - 1:
        window = xin[:, l - (m.d_conv - 1):]
    else:                                   # a short prompt: zeros on the left
        window = torch.cat([torch.zeros((b, m.d_conv - 1 - l, d_inner), dtype=xin.dtype,
                                        device=x.device), xin], dim=1)
    return y, {"state": state, "conv_window": window.contiguous(),
               "index": torch.full((), l, dtype=torch.int32, device=x.device)}


def init_mamba_cache(batch: int, cfg: ModelConfig, dtype=torch.float32, device=None):
    m, d_inner, _ = _dims(cfg)
    return {
        "state": torch.zeros((batch, d_inner, m.d_state), dtype=torch.float32, device=device),
        "conv_window": torch.zeros((batch, m.d_conv - 1, d_inner), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def mamba_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """One-token decode: an O(1) state update and a rolling conv window."""
    _, d_inner, _ = _dims(cfg)
    xz = x @ params["w_in"]
    xin, z = xz[..., :d_inner], xz[..., d_inner:]
    xc = F.silu(_conv1d(xin, params["conv_w"], params["conv_b"],
                        last_window=cache["conv_window"]))
    dt, b_mat, c_mat = _ssm_inputs(params, xc, cfg)
    decay, drive = discretize(dt, b_mat, xc, params["log_a"])
    s = decay[:, 0] * cache["state"] + drive[:, 0]
    y = torch.einsum("bis,bs->bi", s, c_mat[:, 0].float())[:, None, :]
    y = y.to(x.dtype) + params["d_skip"].to(x.dtype) * xc
    y = (y * F.silu(z)) @ params["w_out"]
    window = torch.cat([cache["conv_window"][:, 1:], xin], dim=1)
    return y, {"state": s, "conv_window": window, "index": cache["index"] + 1}
