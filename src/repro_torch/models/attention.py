"""Attention mixers, ported from ``repro/models/attention.py``: GQA
(qk-norm, sliding windows) and DeepSeek-V2's Multi-head Latent Attention.

Two entry modes for each:
  * :func:`gqa_apply` / :func:`mla_apply` — the full sequence (prefill).
    Both of the reference's branches (its L^2 ``sdpa`` below 1024 tokens
    and its online-softmax ``sdpa_blockwise`` from 1024) compute the same
    function; here both go through the flash-attention kernel
    (``kernels.flash_attention``), which takes ``[B, H, L, D]``: the
    projections are transposed to it and back around the call.  MLA's q/k
    and v head dims differ (192 and 128 at full width) and its scale is
    ``qk_head_dim ** -0.5``; the kernel takes one head dim from its
    instances, so :func:`_padded_attention` pads q, k and v with zero
    columns to the smallest instance that holds both, passes the scale
    and keeps v's columns of the output.
  * :func:`gqa_decode` / :func:`mla_decode` — one new token against the
    cache, with the reference's own plain math (:func:`sdpa` over the
    cache and a slot mask; MLA's absorbed latent-space attention): the
    reference runs no kernel there either.

A GQA cache is a dict of ``k``/``v`` ``[B, cap, Hkv, D]`` and an
``index`` (a 0-d int32 tensor on the cache's device, so a decode step
never waits for the host); sliding-window layers keep a ring buffer of
the window's size.  An MLA cache holds only the latent ``c_kv [B, cap,
kv_lora]`` and ``k_rope [B, cap, rope]``, and its ``index``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention, padded_head_dim
from repro_torch.models.layers import apply_rope, dense_init, l2norm, rmsnorm_apply

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


# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention (MLA)
# ---------------------------------------------------------------------------
#
# Projections (names follow the DeepSeek-V2 paper):
#   q:  x --(wq_a: d->q_lora)--> norm --(wq_b: q_lora -> H*(nope+rope))-->
#   kv: x --(wkv_a: d->(kv_lora + rope))-->  latent c_kv [kv_lora] + k_rope
#       c_kv --(wkv_b: kv_lora -> H*(nope + v))--> k_nope, v
# The decode cache stores only (c_kv, k_rope): (kv_lora + rope) a position.


def _padded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      m: MLAConfig) -> torch.Tensor:
    """Causal attention of q/k ``[B, L, H, qk_head_dim]`` and v ``[B, L, H,
    v_head_dim]`` at scale ``qk_head_dim ** -0.5`` through the flash
    kernel's ``padded_head_dim`` instance: zero columns add nothing to a
    score and come out of v as zeros; the scale is the kernel's argument,
    applied to the fp32 scores, so a bf16 q is not rounded again."""
    d = padded_head_dim(max(m.qk_head_dim, m.v_head_dim))

    def pad(t):
        return _heads_first(torch.nn.functional.pad(t, (0, d - t.shape[-1])))

    out = flash_attention(pad(q), pad(k), pad(v), causal=True, scale=m.qk_head_dim ** -0.5)
    return out[..., : m.v_head_dim].transpose(1, 2)      # [B, L, H, v_head_dim]


def mla_init(gen, cfg: ModelConfig, device, dtype=torch.float32):
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, device, dtype),
        "q_norm": torch.ones((m.q_lora_rank,), device=device, dtype=dtype),
        "wq_b": dense_init(gen, m.q_lora_rank, h * m.qk_head_dim, device, dtype),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, device, dtype),
        "kv_norm": torch.ones((m.kv_lora_rank,), device=device, dtype=dtype),
        "wkv_b": dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim),
                            device, dtype),
        "wo": dense_init(gen, h * m.v_head_dim, d, device, dtype),
    }


def _mla_q(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    m: MLAConfig = cfg.mla
    b, l, _ = x.shape
    cq = rmsnorm_apply({"scale": params["q_norm"]}, x @ params["wq_a"], cfg.norm_eps)
    q = (cq @ params["wq_b"]).reshape(b, l, cfg.num_heads, m.qk_head_dim)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)


def _mla_kv_latent(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    m: MLAConfig = cfg.mla
    kv = x @ params["wkv_a"]                                 # [B, L, kv_lora + rope]
    c_kv = rmsnorm_apply({"scale": params["kv_norm"]}, kv[..., : m.kv_lora_rank],
                         cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]         # [B, L, 1, rope]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_expand(params, c_kv: torch.Tensor, cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    b, l, _ = c_kv.shape
    kv = (c_kv @ params["wkv_b"]).reshape(b, l, cfg.num_heads,
                                          m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def mla_apply(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False,
              cache_len: Optional[int] = None):
    """Full-sequence MLA (prefill); returns (y, the latent cache or None)."""
    m: MLAConfig = cfg.mla
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device).expand(b, l)
    q = _mla_q(params, x, cfg, positions)                    # [B, L, H, nope + rope]
    c_kv, k_rope = _mla_kv_latent(params, x, cfg, positions)
    k_nope, v = _mla_expand(params, c_kv, cfg)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, l, cfg.num_heads,
                                                        m.qk_rope_head_dim)], dim=-1)
    out = _padded_attention(q, k, v, m)
    y = out.reshape(b, l, -1) @ params["wo"]
    if not return_cache:
        return y, None
    cap = cache_len if cache_len is not None else l
    cache = init_mla_cache(b, cap, cfg, dtype=c_kv.dtype, device=x.device)
    cache["c_kv"][:, :l] = c_kv
    cache["k_rope"][:, :l] = k_rope
    cache["index"] = torch.full((), l, dtype=torch.int32, device=x.device)
    return y, cache


def init_mla_cache(batch: int, capacity: int, cfg: ModelConfig, dtype=torch.bfloat16,
                   device=None):
    m: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """One-token MLA decode against the latent cache, in the latent space
    (DeepSeek-V2's absorbed form): q_nope goes through the k half of wkv_b,
    so the scores are dot products with c_kv and the cache stays
    (kv_lora + rope) wide.  The reference's plain fp32 math."""
    m: MLAConfig = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    idx = cache["index"]
    positions = idx.reshape(1, 1).expand(b, 1)
    q = _mla_q(params, x, cfg, positions)                    # [B, 1, H, nope + rope]
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_new, r_new = _mla_kv_latent(params, x, cfg, positions)
    slot = idx.long().reshape(1)
    c_kv = cache["c_kv"].index_copy(1, slot, c_new.to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_copy(1, slot, r_new.to(cache["k_rope"].dtype))
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_k, w_v = wkv_b[..., : m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope.float(), w_k.float())
    scores = torch.einsum("bqhc,bkc->bhqk", q_lat, c_kv.float())
    scores = scores + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    scores = scores * m.qk_head_dim ** -0.5
    valid = torch.arange(c_kv.shape[1], device=x.device) <= idx
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhqk,bkc->bqhc", probs, c_kv.float())      # latent values
    out = torch.einsum("bqhc,chd->bqhd", out_lat, w_v.float())
    y = out.reshape(b, 1, -1).to(x.dtype) @ params["wo"]
    return y, {"c_kv": c_kv, "k_rope": k_rope, "index": idx + 1}
