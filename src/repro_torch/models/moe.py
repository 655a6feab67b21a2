"""Mixture-of-Experts FFN (Jamba, Qwen3-MoE, DeepSeek-V2 style), ported from
``repro/models/moe.py``: the dense formulation that ``launch/serve.py`` uses.

Every token computes a routing distribution, the top-k experts get
renormalised weights in a dense ``[.., E]`` combine matrix, and every
expert's FFN is evaluated on every token, weighted by that matrix.  The
reference does it as one ``[B, E, L, F]`` einsum; here the experts run
one at a time, so that at full width (Jamba-1.5-Large: 16 experts of
24576) the transient stays one ``[B, L, d_expert]`` slab.  The router's
Switch-style load-balance loss comes back beside the output.

The reference's grouped-capacity ``dispatch`` and token-gather
``gather`` formulations are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import NotPorted
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init, normal


def moe_init(gen, d_model: int, cfg: MoEConfig, device, dtype=torch.float32):
    e, de = cfg.num_experts, cfg.d_expert
    p = {
        "router": dense_init(gen, d_model, e, device, torch.float32),   # router in fp32
        "w_gate": normal(gen, (e, d_model, de), d_model ** -0.5, device, dtype),
        "w_up": normal(gen, (e, d_model, de), d_model ** -0.5, device, dtype),
        "w_down": normal(gen, (e, de, d_model), de ** -0.5, device, dtype),
    }
    if cfg.num_shared_experts:
        ds = cfg.d_shared_total
        p["shared"] = {
            "w_gate": dense_init(gen, d_model, ds, device, dtype),
            "w_up": dense_init(gen, d_model, ds, device, dtype),
            "w_down": dense_init(gen, ds, d_model, device, dtype),
        }
    return p


def router_probs(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """[.., L, E] softmax routing probabilities (fp32)."""
    return torch.softmax(x.float() @ params["router"], dim=-1)


def topk_dispatch(probs: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k combine weights as a dense [.., E] matrix, and the aux loss."""
    top_vals, top_idx = torch.topk(probs, cfg.top_k, dim=-1)            # [.., k]
    if cfg.normalize_router_weights:
        top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
    # [.., k, E]; a comparison, not F.one_hot, whose bounds check reads the
    # indices on the host and fails under torch.func.vmap (per-example DP-SGD)
    experts = torch.arange(cfg.num_experts, device=top_idx.device)
    onehot = (top_idx[..., None] == experts).to(probs.dtype)
    combine = torch.einsum("...k,...ke->...e", top_vals, onehot)
    # Switch-style load balance: E * sum_e( mean_frac_tokens_e * mean_prob_e )
    tokens_per_expert = onehot.sum(-2).mean(dim=tuple(range(onehot.ndim - 2)))
    mean_prob = probs.mean(dim=tuple(range(probs.ndim - 1)))
    aux = cfg.num_experts * (tokens_per_expert * mean_prob).sum()
    return combine, aux


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] -> (y [B, L, D], aux loss): every expert on every token,
    weighted by the top-k combine matrix."""
    combine, aux = topk_dispatch(router_probs(params, x, cfg), cfg)   # [B, L, E]
    combine = combine.to(x.dtype)
    y = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        h = F.silu(x @ params["w_gate"][e]) * (x @ params["w_up"][e])  # [B, L, d_expert]
        y = y + (h @ params["w_down"][e]) * combine[..., e:e + 1]
    if cfg.num_shared_experts:
        s = params["shared"]
        y = y + (F.silu(x @ s["w_gate"]) * (x @ s["w_up"])) @ s["w_down"]
    return y, aux


def moe_apply_dispatch(params, x, cfg: MoEConfig, *args, **kwargs):
    raise NotPorted("moe_impl", "dispatch", "dense")


def moe_apply_sparse(params, x, cfg: MoEConfig, *args, **kwargs):
    raise NotPorted("moe_impl", "gather", "dense")
