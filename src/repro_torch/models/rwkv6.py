"""RWKV-6 "Finch" mixer (arXiv:2404.05892) and the RWKV channel-mix FFN,
ported from ``repro/models/rwkv6.py``.

State per head: S in R^[hd, hd] with per-channel (k-dim) decay

    out_t[j] = sum_i r_t[i] * ( S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j] )
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

The prefill (:func:`rwkv6_apply`) runs the whole recurrence through the
WKV-6 kernel (``kernels.rwkv6_scan``), which also returns the final state
for the decode cache; the reference computes the same recurrence with a
chunked ``lax.scan``.  Decode (:func:`rwkv6_decode`) is the reference's
single plain step, :func:`_wkv_step`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, Rwkv6Config
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import dense_init, normal, token_shift, uniform

MIX_NAMES = ("w", "k", "v", "r", "g")


def rwkv6_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    r: Rwkv6Config = cfg.rwkv
    d = cfg.d_model
    h = d // r.head_dim
    return {
        # static token-shift interpolators (per channel, per branch)
        "mu_base": uniform(gen, (5, d), 0.0, 0.5, device, dtype),
        "mu_x": uniform(gen, (d,), 0.0, 0.5, device, dtype),
        # data-dependent token-shift LoRA: d -> 5*rank -> 5*d
        "ts_w1": dense_init(gen, d, 5 * r.tokenshift_lora_rank, device, dtype),
        "ts_w2": normal(gen, (5, r.tokenshift_lora_rank, d), 0.01, device, dtype),
        # projections
        "w_r": dense_init(gen, d, d, device, dtype),
        "w_k": dense_init(gen, d, d, device, dtype),
        "w_v": dense_init(gen, d, d, device, dtype),
        "w_g": dense_init(gen, d, d, device, dtype),
        "w_o": dense_init(gen, d, d, device, dtype),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x W1) W2))
        "decay_w0": torch.full((d,), -5.0, device=device, dtype=dtype),
        "decay_w1": dense_init(gen, d, r.decay_lora_rank, device, dtype),
        "decay_w2": normal(gen, (r.decay_lora_rank, d), 0.01, device, dtype),
        # per-(head, channel) bonus for the current token
        "u": normal(gen, (h, r.head_dim), 0.1, device, dtype),
        # per-head output group-norm
        "gn_scale": torch.ones((d,), device=device, dtype=dtype),
    }


def _branch_inputs(params, x: torch.Tensor, last: Optional[torch.Tensor]):
    """Data-dependent token-shift mixing (the Finch innovation)."""
    xs = token_shift(x, last)
    dx = xs - x
    xxx = x + dx * params["mu_x"].to(x.dtype)
    lora = torch.tanh(xxx @ params["ts_w1"])
    b, l, _ = x.shape
    rank = params["ts_w2"].shape[1]
    lora = lora.reshape(b, l, 5, rank)
    mu_dyn = torch.einsum("blfr,frd->fbld", lora, params["ts_w2"].to(x.dtype))
    return {name: x + dx * (params["mu_base"][i].to(x.dtype) + mu_dyn[i])
            for i, name in enumerate(MIX_NAMES)}


def _rkvwg(params, x: torch.Tensor, cfg: ModelConfig, last: Optional[torch.Tensor] = None):
    hd = cfg.rwkv.head_dim
    h = cfg.d_model // hd
    b, l, _ = x.shape
    br = _branch_inputs(params, x, last)
    r = (br["r"] @ params["w_r"]).reshape(b, l, h, hd)
    k = (br["k"] @ params["w_k"]).reshape(b, l, h, hd)
    v = (br["v"] @ params["w_v"]).reshape(b, l, h, hd)
    g = F.silu(br["g"] @ params["w_g"])
    logw = -torch.exp(params["decay_w0"].float()
                      + (torch.tanh(br["w"] @ params["decay_w1"]) @ params["decay_w2"]).float())
    w = torch.exp(logw).reshape(b, l, h, hd)                  # in (0, 1)
    return r, k, v, w, g


def _wkv_step(state: torch.Tensor, rkvw, u: torch.Tensor):
    """One recurrence step. state [B, H, hd, hd]; r/k/v/w [B, H, hd]."""
    r, k, v, w = rkvw
    kv = k[..., :, None] * v[..., None, :]
    att = state + u[None, :, :, None] * kv
    out = torch.einsum("bhi,bhij->bhj", r, att)
    return w[..., :, None] * state + kv, out


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, eps: float = 1e-5):
    """Per-head layer norm on [B, L, D] (population variance, eps 1e-5)."""
    b, l, d = x.shape
    xh = x.reshape(b, l, h, d // h).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(b, l, d) * scale.float()).to(x.dtype)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    return t.float().transpose(1, 2).contiguous()           # [B, L, H, D] -> [B, H, L, D]


def rwkv6_apply(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence time mix (prefill).  Cache = (last token's x, state)."""
    h = cfg.d_model // cfg.rwkv.head_dim
    b, l, d = x.shape
    r, k, v, w, g = _rkvwg(params, x, cfg)
    out, state = rwkv6_scan(_heads_first(r), _heads_first(k), _heads_first(v),
                            _heads_first(w), params["u"].float())
    out = out.transpose(1, 2).reshape(b, l, d)
    y = _group_norm(out.to(x.dtype), params["gn_scale"], h) * g
    y = y @ params["w_o"]
    if not return_cache:
        return y, None
    return y, {"last_x": x[:, -1], "state": state,
               "index": torch.full((), l, dtype=torch.int32, device=x.device)}


def init_rwkv6_cache(batch: int, cfg: ModelConfig, dtype=torch.float32, device=None):
    rcfg: Rwkv6Config = cfg.rwkv
    h = cfg.d_model // rcfg.head_dim
    return {
        "last_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, rcfg.head_dim, rcfg.head_dim),
                             dtype=torch.float32, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def rwkv6_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """One-token decode: an O(1) state update."""
    h = cfg.d_model // cfg.rwkv.head_dim
    b, _, d = x.shape
    r, k, v, w, g = _rkvwg(params, x, cfg, last=cache["last_x"])
    state, out = _wkv_step(cache["state"], tuple(t[:, 0].float() for t in (r, k, v, w)),
                           params["u"].float())
    y = _group_norm(out.reshape(b, 1, d).to(x.dtype), params["gn_scale"], h) * g
    y = y @ params["w_o"]
    return y, {"last_x": x[:, -1], "state": state, "index": cache["index"] + 1}


# ---------------------------------------------------------------------------
# RWKV channel mix (the FFN between time-mix layers)
# ---------------------------------------------------------------------------


def cmix_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    mu_k = uniform(gen, (d,), 0.0, 0.5, device, dtype)
    return {
        "mu_k": mu_k,
        # the reference draws mu_r from the same key as mu_k: they are equal
        "mu_r": mu_k.clone(),
        "w_k": dense_init(gen, d, f, device, dtype),
        "w_v": dense_init(gen, f, d, device, dtype),
        "w_r": dense_init(gen, d, d, device, dtype),
    }


def cmix_apply(params, x: torch.Tensor, last: Optional[torch.Tensor] = None):
    xs = token_shift(x, last)
    dx = xs - x
    xk = x + dx * params["mu_k"].to(x.dtype)
    xr = x + dx * params["mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ params["w_k"]))
    return torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])
