"""Mixture-of-Experts FFN (Jamba, Qwen3-MoE, DeepSeek-V2 style), ported from
``repro/models/moe.py``: its three formulations of one function.

Every token computes a routing distribution and gets its top-k experts
with renormalised weights; the router's Switch-style load-balance loss
comes back beside the output.

* :func:`moe_apply` (``dense``): every expert's FFN on every token,
  weighted by a dense ``[.., E]`` combine matrix.  The reference does it
  as one ``[B, E, L, F]`` einsum; here the experts run one at a time, so
  that at full width (Jamba-1.5-Large: 16 experts of 24576) the
  transient stays one ``[B, L, d_expert]`` slab.
* :func:`moe_apply_dispatch` (``dispatch``, the reference's serving
  default): GShard-style grouped capacity dispatch.  Tokens in groups of
  ``group_size``, each expert a buffer of ``C`` slots filled top-k slot
  by top-k slot in token order, overflow dropped; the expert FFNs run as
  batched products over E on ``[G, E, C, D]``.
* :func:`moe_apply_sparse` (``gather``): only each token's k experts.
  The reference gathers a ``[B, L, k, D, F]`` copy of the weights (193 GB
  for 1024 tokens at DeepSeek-V2's width); here the (token, slot) pairs
  are grouped by expert and each expert's FFN runs on its own tokens,
  each result written once into a ``[T, k, D]`` slab that is summed over
  k in slot order: no atomics, so the same on every run.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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


def _top_k(probs: torch.Tensor, cfg: MoEConfig):
    """(the top-k weights, renormalised where the config says, and their
    expert indices), each [.., k]."""
    top_vals, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_router_weights:
        top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
    return top_vals, top_idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # a comparison, not F.one_hot, whose bounds check reads the indices on
    # the host and fails under torch.func.vmap (per-example DP-SGD)
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _aux_loss(probs: torch.Tensor, onehot: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load balance: E * sum_e( mean_frac_tokens_e * mean_prob_e ),
    ``onehot`` [.., k, E]."""
    tokens_per_expert = onehot.sum(-2).mean(dim=tuple(range(onehot.ndim - 2)))
    mean_prob = probs.mean(dim=tuple(range(probs.ndim - 1)))
    return cfg.num_experts * (tokens_per_expert * mean_prob).sum()


def _shared(params, x: torch.Tensor) -> torch.Tensor:
    s = params["shared"]
    return (F.silu(x @ s["w_gate"]) * (x @ s["w_up"])) @ s["w_down"]


def topk_dispatch(probs: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k combine weights as a dense [.., E] matrix, and the aux loss."""
    top_vals, top_idx = _top_k(probs, cfg)                              # [.., k]
    onehot = _one_hot(top_idx, cfg.num_experts, probs.dtype)            # [.., k, E]
    combine = torch.einsum("...k,...ke->...e", top_vals, onehot)
    return combine, _aux_loss(probs, onehot, cfg)


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
        y = y + _shared(params, x)
    return y, aux


def dispatch_slots(probs: torch.Tensor, cfg: MoEConfig, capacity_factor: float = 1.25):
    """The grouped-capacity routing of ``probs`` [G, S, E]: (the top-k
    weights and experts [G, S, k], each pair's slot in its expert's buffer
    [G, S, k], whether the pair was kept [G, S, k] bool, the capacity C).

    ``C = min(S, max(4, int(S * k / E * capacity_factor)))``.  Slot j of
    every token is placed before slot j + 1 of any token, in token order
    within a slot: a pair's position is the count of earlier pairs routed
    to its expert; pairs at C or past it are dropped."""
    g, s, e = probs.shape
    top_vals, top_idx = _top_k(probs, cfg)
    cap = min(int(max(4, s * cfg.top_k / e * capacity_factor)), s)
    onehot = _one_hot(top_idx, e, torch.float32)                        # [G, S, k, E]
    count = torch.zeros((g, e), dtype=torch.float32, device=probs.device)
    slots, kept = [], []
    for j in range(cfg.top_k):
        assign = onehot[:, :, j, :]                                     # [G, S, E]
        pos = torch.cumsum(assign, dim=1) * assign - 1.0 + count[:, None, :] * assign
        keep = (pos >= 0) & (pos < cap) & (assign > 0)
        slots.append((pos * assign).sum(-1))                            # [G, S]
        kept.append(keep.any(-1))
        count = count + assign.sum(1)
    return top_vals, top_idx, torch.stack(slots, -1).long(), torch.stack(kept, -1), cap


def moe_apply_dispatch(params, x: torch.Tensor, cfg: MoEConfig, capacity_factor: float = 1.25,
                       group_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] -> (y [B, L, D], aux loss) by grouped capacity dispatch.

    Groups of ``group_size`` tokens (a token count it does not divide is
    one group), :func:`dispatch_slots`' buffers gathered into ``[G, E, C,
    D]``, each expert's FFN as one batched product over E, and each kept
    pair's output at its slot brought back times its weight.  Dropped
    pairs add nothing (the shared experts still run)."""
    b, l, d = x.shape
    tokens = b * l
    s = min(group_size, tokens)
    if tokens % s:
        s = tokens                      # ragged: one group
    g = tokens // s
    xt = x.reshape(g, s, d)
    probs = router_probs(params, xt, cfg)                              # [G, S, E]
    top_vals, top_idx, slot, _, cap = dispatch_slots(probs, cfg, capacity_factor)
    aux = _aux_loss(probs, _one_hot(top_idx, cfg.num_experts, probs.dtype), cfg)
    # [G, S, E, C] one-hots of the kept pairs, built by comparison (a
    # dropped pair's slot is past C: its one-hot is zero), and their
    # weights, added slot by slot as the reference adds them
    dispatch = xt.new_zeros((g, s, cfg.num_experts, cap))
    combine = xt.new_zeros((g, s, cfg.num_experts, cap))
    for j in range(cfg.top_k):
        d_j = (_one_hot(top_idx[:, :, j], cfg.num_experts, x.dtype)[..., None]
               * _one_hot(slot[:, :, j], cap, x.dtype)[:, :, None, :])
        dispatch = dispatch + d_j
        combine = combine + top_vals[:, :, j, None, None].to(x.dtype) * d_j
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xt)                 # [G, E, C, D]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, params["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine, ye)
    y = y.reshape(b, l, d)
    if cfg.num_shared_experts:
        y = y + _shared(params, x)
    return y, aux


def moe_apply_sparse(params, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] -> (y [B, L, D], aux loss): each token's top-k experts
    only.  The (token, slot) pairs are sorted by expert (stably, so token
    order within an expert); each expert with pairs runs its FFN on its
    tokens and writes each result once into a [T, k, D] slab, which is
    summed over k in slot order, weighted.  The per-expert counts are read
    on the host (one synchronisation a call)."""
    b, l, d = x.shape
    probs = router_probs(params, x, cfg)
    top_vals, top_idx = _top_k(probs, cfg)                             # [B, L, k]
    aux = _aux_loss(probs, _one_hot(top_idx, cfg.num_experts, probs.dtype), cfg)
    xf = x.reshape(-1, d)
    pairs = top_idx.reshape(-1)                                        # [T * k]
    order = torch.argsort(pairs, stable=True)
    counts = torch.bincount(pairs, minlength=cfg.num_experts).tolist()
    slab = x.new_zeros((pairs.numel(), d))
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = order[start:start + n]
            xe = xf[rows // cfg.top_k]
            h = F.silu(xe @ params["w_gate"][e]) * (xe @ params["w_up"][e])
            slab[rows] = h @ params["w_down"][e]
            start += n
    slab = slab.reshape(b, l, cfg.top_k, d)
    w = top_vals.to(x.dtype)
    y = torch.zeros_like(x)
    for j in range(cfg.top_k):
        y = y + slab[:, :, j] * w[..., j:j + 1]
    if cfg.num_shared_experts:
        y = y + _shared(params, x)
    return y, aux
