"""GQA attention (qk-norm, sliding windows), ported from ``repro/models/attention.py``.

Two entry modes:
  * :func:`gqa_apply` — the full sequence (prefill).  Both of the
    reference's branches (its L^2 ``sdpa`` below 1024 tokens and its
    online-softmax ``sdpa_blockwise`` from 1024) compute the same
    function; here both go through the flash-attention kernel
    (``kernels.flash_attention``), which takes ``[B, H, L, D]``: the
    projections are transposed to it and back around the call.
  * :func:`gqa_decode` — one new token against the cache, with the
    reference's own plain math (:func:`sdpa` over the cache and a slot
    mask): the reference runs no kernel there either.

The cache is a dict of ``k``/``v`` ``[B, cap, Hkv, D]`` and an ``index``
(a 0-d int32 tensor on the cache's device, so a decode step never waits
for the host).  Sliding-window layers keep a ring buffer of the window's
size.  DeepSeek-V2's MLA is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import NotPorted
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, l2norm

NEG_INF = -1e30


def causal_mask(q_len: int, kv_len: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] additive mask. Queries are the *last* q_len positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return torch.where(ok, 0.0, NEG_INF).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Scaled-dot-product attention with GQA head broadcasting, fp32 softmax.

    q [B, Lq, Hq, D]; k/v [B, Lk, Hkv, D]; ``mask`` broadcasts over
    [B, Hkv, G, Lq, Lk]."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, lq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, lq, hq, v.shape[-1]).to(q.dtype)


def _head_dim(cfg: ModelConfig) -> int:
    return cfg.head_dim if cfg.head_dim is not None else cfg.d_model // cfg.num_heads


def gqa_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = _head_dim(cfg)
    p = {
        "wq": dense_init(gen, d, hq * hd, device, dtype),
        "wk": dense_init(gen, d, hkv * hd, device, dtype),
        "wv": dense_init(gen, d, hkv * hd, device, dtype),
        "wo": dense_init(gen, hq * hd, d, device, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device, dtype=dtype)
        p["k_norm"] = torch.ones((hd,), device=device, dtype=dtype)
    return p


def _gqa_project(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, l, _ = x.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    hd = _head_dim(cfg)
    q = (x @ params["wq"]).reshape(b, l, hq, hd)
    k = (x @ params["wk"]).reshape(b, l, hkv, hd)
    v = (x @ params["wv"]).reshape(b, l, hkv, hd)
    if cfg.qk_norm:
        q = l2norm(q) * params["q_norm"].to(q.dtype)
        k = l2norm(k) * params["k_norm"].to(k.dtype)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2).contiguous()               # [B, L, H, D] -> [B, H, L, D]


def gqa_apply(params, x: torch.Tensor, cfg: ModelConfig, window: Optional[int] = None,
              return_cache: bool = False, cache_len: Optional[int] = None):
    """Full-sequence GQA attention (prefill); returns (y, cache or None)."""
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device).expand(b, l)
    q, k, v = _gqa_project(params, x, cfg, positions)
    out = flash_attention(_heads_first(q), _heads_first(k), _heads_first(v),
                          causal=True, window=window)
    y = out.transpose(1, 2).reshape(b, l, -1) @ params["wo"]
    if not return_cache:
        return y, None
    cap = cache_len if cache_len is not None else l
    cache = init_gqa_cache(b, cap, cfg, dtype=k.dtype, window=window, device=x.device)
    ring_cap = cache["k"].shape[1]                       # == min(cap, window)
    if l >= ring_cap:
        # keep the trailing window, each position at its ring slot
        slots = torch.arange(l - ring_cap, l, device=x.device) % ring_cap
        cache["k"][:, slots] = k[:, -ring_cap:]
        cache["v"][:, slots] = v[:, -ring_cap:]
    else:
        cache["k"][:, :l] = k
        cache["v"][:, :l] = v
    cache["index"] = torch.full((), l, dtype=torch.int32, device=x.device)
    return y, cache


def init_gqa_cache(batch: int, capacity: int, cfg: ModelConfig, dtype=torch.bfloat16,
                   window: Optional[int] = None, device=None):
    """An empty KV cache.  Sliding-window layers allocate only the window
    (a ring buffer)."""
    hkv = cfg.num_kv_heads
    hd = _head_dim(cfg)
    cap = min(capacity, window) if window is not None else capacity
    return {
        "k": torch.zeros((batch, cap, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, hkv, hd), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),  # positions seen
    }


def gqa_decode(params, x: torch.Tensor, cache, cfg: ModelConfig,
               window: Optional[int] = None):
    """One-token decode. x [B, 1, D]; returns (y, the new cache)."""
    b = x.shape[0]
    idx = cache["index"]
    positions = idx.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _gqa_project(params, x, cfg, positions)
    cap = cache["k"].shape[1]
    slot = (idx % cap if window is not None else idx).long().reshape(1)
    k = cache["k"].index_copy(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, slot, v_new.to(cache["v"].dtype))
    pos = torch.arange(cap, device=x.device)
    if window is not None:
        valid = (pos <= slot) | (idx >= cap)             # a full ring: all slots valid
    else:
        valid = pos <= idx
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, :]
    out = sdpa(q, k, v, mask)
    y = out.reshape(b, 1, -1) @ params["wo"]
    return y, {"k": k, "v": v, "index": idx + 1}


def mla_init(*args, **kwargs):
    raise NotPorted("mixer", "mla", "attn, rwkv6, mamba")


mla_apply = mla_decode = init_mla_cache = mla_init
