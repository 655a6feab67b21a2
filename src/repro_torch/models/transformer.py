"""Decoder-only token-model stack, ported from ``repro/models/transformer.py``.

* **Per-layer block dispatch**: each layer's mixer (GQA / MLA / RWKV-6 /
  Mamba) and FFN (dense / MoE / RWKV channel mix) comes from
  ``ModelConfig.layer_spec(i)``, so Jamba (Mamba with one attention layer
  in eight, MoE on every other layer) and Gemma-3 (5:1 local:global
  windows) are plain configs.
* **The reference's parameter tree**: :func:`plan_groups` splits the
  layers into an unrolled prefix (``prefix_layers``, a list) and one
  periodic group whose parameters are stacked along a leading repeat axis
  (``scan_layers``, one dict per period position).  The reference runs the
  group with ``lax.scan``; here a loop over the repeats indexes the
  stacked leaves, so a reference tree converts leaf by leaf.
* **Training**: :func:`next_token_loss`, the reference's mean next-token
  cross-entropy plus the MoE aux term, through :func:`forward` (whose
  attention layers differentiate through the flash-attention kernels);
  ``remat=True`` checkpoints each repeat of the periodic group, where the
  reference checkpoints its scan body.
* **Precision**: parameters in bf16 (the ``mixed`` and ``bf16_train``
  policies, and bf16 serving) keep the reference's fp32 islands: RMSNorm
  statistics, rope, attention's softmax (cast back to q's dtype), MLA's
  absorbed decode, the scans' state, the MoE router and the logits.
* **Serving**: :func:`prefill` returns logits of the last position and
  per-layer caches (KV ring buffers, MLA's latent cache, RWKV and Mamba
  states); :func:`decode_step` advances one token.  Every layer's prefill
  mixer runs one of the port's kernels (flash attention, MLA's padded
  to an instance of it, the WKV-6 scan, the selective scan); decode runs
  the reference's plain per-step math.  ``moe_impl`` picks the MoE
  formulation (``dense``, ``gather`` or the grouped-capacity
  ``dispatch``, the reference's default for ``prefill`` and
  ``decode_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (_sinusoid, dense_init, embed_init, mlp_apply,
                                       mlp_init, rmsnorm_apply, rmsnorm_init,
                                       sinusoidal_positions)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------


def _signature(cfg: ModelConfig, i: int):
    spec = cfg.layer_spec(i)
    return (spec.mixer, spec.ffn, cfg.dense_ff_for_layer(i), spec.sliding_window)


@dataclasses.dataclass(frozen=True)
class ScanGroup:
    """``n_repeats`` repetitions of a ``period``-layer block pattern.

    Sliding windows are part of the group signature, so every period
    position has one static window (gemma3's 5 local + 1 global is
    period 6)."""

    start: int
    period: int
    n_repeats: int
    specs: Tuple[LayerSpec, ...]            # one per period position


def plan_groups(cfg: ModelConfig, max_period: int = 8) -> Tuple[Tuple[int, ...], Optional[ScanGroup]]:
    """Split layers into an unrolled prefix and one periodic group.

    Returns (prefix layer indices, group or None).  The group covers the
    longest periodic suffix whose layers have the same parameter shapes
    and specs; the leading layers that do not fit are the prefix."""
    n = cfg.num_layers
    sigs = [_signature(cfg, i) for i in range(n)]
    for start in range(n):
        remaining = n - start
        if remaining < 2:
            break
        for p in range(1, max_period + 1):
            if remaining % p or remaining // p < 2:
                continue
            if all(sigs[i] == sigs[start + ((i - start) % p)] for i in range(start, n)):
                specs = tuple(cfg.layer_spec(start + j) for j in range(p))
                return tuple(range(start)), ScanGroup(start, p, remaining // p, specs)
    return tuple(range(n)), None


def _stacked(make, n: int):
    """``make(r)`` for r < n stacked along a new leading axis, built into
    preallocated tensors so that the peak is the stack plus one layer."""
    first = make(0)
    leaves = tree_leaves(first)
    out = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device) for t in leaves]
    for o, t in zip(out, leaves):
        o[0].copy_(t)
    like = tree_map(lambda t: None, first)
    del first, leaves
    for r in range(1, n):
        for o, t in zip(out, tree_leaves(make(r))):
            o[r].copy_(t)
    return tree_unflatten(like, out)


def _repeat(tree, r: int):
    """The ``r``-th repeat of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[r], tree)


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Single-layer init / apply
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, i: int, device, dtype):
    spec = cfg.layer_spec(i)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, device, dtype),
                         "norm2": rmsnorm_init(cfg.d_model, device, dtype)}
    if spec.mixer == "attn":
        p["mixer"] = attn.gqa_init(gen, cfg, device, dtype)
    elif spec.mixer == "mla":
        p["mixer"] = attn.mla_init(gen, cfg, device, dtype)
    elif spec.mixer == "rwkv6":
        p["mixer"] = rwkv_mod.rwkv6_init(gen, cfg, device, dtype)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, device, dtype)
    if spec.ffn == "moe":
        p["ffn"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe, device, dtype)
    elif spec.mixer == "rwkv6":
        p["ffn"] = rwkv_mod.cmix_init(gen, cfg, device, dtype)
    else:
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.dense_ff_for_layer(i),
                            cfg.ffn_activation, device, dtype)
    return p


_MOE_IMPLS = {"dense": moe_mod.moe_apply, "gather": moe_mod.moe_apply_sparse,
              "dispatch": moe_mod.moe_apply_dispatch}


def _layer_apply(params, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, window,
                 cache=None, decode: bool = False, make_cache: bool = False,
                 cache_len: Optional[int] = None, moe_impl: str = "dense"):
    """One transformer block. Returns (x, new cache, aux loss)."""
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    new_cache = None
    if spec.mixer == "attn":
        if decode:
            y, new_cache = attn.gqa_decode(params["mixer"], h, cache, cfg, window=window)
        else:
            y, new_cache = attn.gqa_apply(params["mixer"], h, cfg, window=window,
                                          return_cache=make_cache, cache_len=cache_len)
    elif spec.mixer == "mla":
        if decode:
            y, new_cache = attn.mla_decode(params["mixer"], h, cache, cfg)
        else:
            y, new_cache = attn.mla_apply(params["mixer"], h, cfg,
                                          return_cache=make_cache, cache_len=cache_len)
    elif spec.mixer == "rwkv6":
        if decode:
            y, new_cache = rwkv_mod.rwkv6_decode(params["mixer"], h, cache["mixer"], cfg)
        else:
            y, new_cache = rwkv_mod.rwkv6_apply(params["mixer"], h, cfg,
                                                return_cache=make_cache)
    elif spec.mixer == "mamba":
        if decode:
            y, new_cache = mamba_mod.mamba_decode(params["mixer"], h, cache, cfg)
        else:
            y, new_cache = mamba_mod.mamba_apply(params["mixer"], h, cfg,
                                                 return_cache=make_cache)
    else:
        raise ValueError(spec.mixer)
    x = x + y
    h2 = rmsnorm_apply(params["norm2"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "moe":
        y2, aux = _MOE_IMPLS[moe_impl](params["ffn"], h2, cfg.moe)
    elif spec.mixer == "rwkv6":
        # the channel mix's token shift is stateful across decode steps too
        last = cache["cmix_last"] if decode else None
        y2 = rwkv_mod.cmix_apply(params["ffn"], h2, last=last)
        if new_cache is not None:
            new_cache = {"mixer": new_cache, "cmix_last": h2[:, -1]}
    else:
        y2 = mlp_apply(params["ffn"], h2, cfg.ffn_activation)
    return x + y2, new_cache, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def init(gen: Optional[torch.Generator], cfg: ModelConfig, device, dtype=torch.float32):
    """Model parameters (a dict tree in the reference's layout), drawn from
    ``gen`` on ``device``.  On the ``meta`` device (``gen`` None) nothing
    is drawn or stored."""
    device = torch.device(device)
    prefix, group = plan_groups(cfg)
    vpad = cfg.padded_vocab
    params: Dict[str, Any] = {}
    if cfg.num_codebooks > 1:
        params["embed"] = torch.stack([embed_init(gen, vpad, cfg.d_model, device, dtype)
                                       for _ in range(cfg.num_codebooks)])
    else:
        params["embed"] = embed_init(gen, vpad, cfg.d_model, device, dtype)
    params["prefix_layers"] = [_layer_init(gen, cfg, i, device, dtype) for i in prefix]
    if group is not None:
        params["scan_layers"] = [
            _stacked(lambda r, j=j: _layer_init(gen, cfg, group.start + r * group.period + j,
                                                device, dtype), group.n_repeats)
            for j in range(group.period)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, device, dtype)
    if not cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            params["lm_head"] = torch.stack([dense_init(gen, cfg.d_model, vpad, device, dtype)
                                             for _ in range(cfg.num_codebooks)])
        else:
            params["lm_head"] = dense_init(gen, cfg.d_model, vpad, device, dtype)
    return params


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count, from :func:`init` on the ``meta`` device.

    ``active_only`` subtracts the routed experts a token does not use
    (only top_k of num_experts are live)."""
    total = sum(t.numel() for t in tree_leaves(init(None, cfg, "meta")))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
        total -= n_moe_layers * 3 * cfg.d_model * m.d_expert * (m.num_experts - m.top_k)
    return total


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, position_offset=0):
    """tokens [B, L] or [B, L, K] (codebooks) -> [B, L, D].  In decode,
    ``position_offset`` is the cache's index (a 0-d tensor)."""
    if cfg.num_codebooks > 1:
        x = sum(params["embed"][k][tokens[..., k]] for k in range(cfg.num_codebooks))
    else:
        x = params["embed"][tokens]
    if cfg.pos_embedding == "sinusoidal":
        if isinstance(position_offset, int) and position_offset == 0:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device, x.dtype)[None]
        else:
            pos = torch.as_tensor(position_offset, device=x.device).float().reshape(1)
            x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)[None]
    return x


def _mask_pad(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, torch.full_like(logits, -1e30), logits)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, L, D] -> fp32 logits over the padded vocab ([B, L, Vp] or
    [B, L, K, Vp]); the padding rows are -1e30."""
    x32 = x.float()
    if cfg.num_codebooks > 1:
        if cfg.tie_embeddings:
            logits = torch.einsum("bld,kvd->blkv", x32, params["embed"].float())
        else:
            logits = torch.einsum("bld,kdv->blkv", x32, params["lm_head"].float())
        return _mask_pad(logits, cfg)
    if cfg.tie_embeddings:
        logits = x32 @ params["embed"].float().T
    else:
        logits = x32 @ params["lm_head"].float()
    return _mask_pad(logits, cfg)


def _group_forward(params, x: torch.Tensor, aux: torch.Tensor, cfg: ModelConfig,
                   group: ScanGroup, remat: bool, moe_impl: str):
    """The periodic group's repeats in order (training / eval, no caches).
    With ``remat`` each repeat's ``period`` layers run under a checkpoint,
    as the reference checkpoints its scan body: their activations are
    recomputed in the backward instead of kept."""

    def body(h, a, layer_params):
        for j, spec in enumerate(group.specs):
            h, _, aj = _layer_apply(layer_params[j], h, cfg, spec, spec.sliding_window,
                                    moe_impl=moe_impl)
            a = a + aj
        return h, a

    for r in range(group.n_repeats):
        layer_params = [_repeat(p, r) for p in params["scan_layers"]]
        if remat:
            x, aux = checkpoint(body, x, aux, layer_params, use_reentrant=False)
        else:
            x, aux = body(x, aux, layer_params)
    return x, aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, remat: bool = False,
            moe_impl: str = "dense"):
    """Full-sequence forward pass. Returns (logits, aux loss).  ``remat``
    checkpoints each repeat of the periodic layer group (the values do
    not change)."""
    prefix, group = plan_groups(cfg)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n, i in enumerate(prefix):
        spec = cfg.layer_spec(i)
        x, _, a = _layer_apply(params["prefix_layers"][n], x, cfg, spec,
                               spec.sliding_window, moe_impl=moe_impl)
        aux = aux + a
    if group is not None:
        x, aux = _group_forward(params, x, aux, cfg, group, remat, moe_impl)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def token_loss_of(logits: torch.Tensor, aux: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig, aux_coef: Optional[float] = None):
    """:func:`next_token_loss` from the forward's ``(logits, aux)``."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()                       # [B, L-1] or [B, L-1, K]
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    coef = aux_coef if aux_coef is not None else (cfg.moe.router_aux_coef if cfg.moe else 0.0)
    return loss + coef * aux, {"ce": loss, "aux": aux}


def next_token_loss(params, batch, cfg: ModelConfig, remat: bool = False,
                    moe_impl: str = "dense", aux_coef: Optional[float] = None):
    """Mean next-token cross-entropy (+ the MoE load-balance aux term, at
    ``aux_coef`` or the config's ``router_aux_coef``): ``(loss, {"ce",
    "aux"})``.  With codebooks the mean runs over every codebook too.
    ``remat`` as in :func:`forward`."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg, remat=remat, moe_impl=moe_impl)
    return token_loss_of(logits, aux, tokens, cfg, aux_coef)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _cache_for_layer(batch: int, capacity: int, cfg: ModelConfig, spec: LayerSpec,
                     window: Optional[int], dtype, device):
    if spec.mixer == "attn":
        return attn.init_gqa_cache(batch, capacity, cfg, dtype, window=window, device=device)
    if spec.mixer == "mla":
        return attn.init_mla_cache(batch, capacity, cfg, dtype, device=device)
    if spec.mixer == "rwkv6":
        return {"mixer": rwkv_mod.init_rwkv6_cache(batch, cfg, dtype, device),
                "cmix_last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba_cache(batch, cfg, dtype, device)
    raise ValueError(spec.mixer)


def init_caches(batch: int, capacity: int, cfg: ModelConfig, dtype=torch.bfloat16,
                device=None):
    """Empty per-layer caches: {"prefix": list, "scan": stacked per period
    position, or None}."""
    prefix, group = plan_groups(cfg)
    pre = [_cache_for_layer(batch, capacity, cfg, cfg.layer_spec(i),
                            cfg.layer_spec(i).sliding_window, dtype, device) for i in prefix]
    scan_caches = None
    if group is not None:
        scan_caches = [_stack([_cache_for_layer(batch, capacity, cfg, spec,
                                                spec.sliding_window, dtype, device)
                               for _ in range(group.n_repeats)])
                       for spec in group.specs]
    return {"prefix": pre, "scan": scan_caches}


def _run_layers(params, x: torch.Tensor, cfg: ModelConfig, caches=None, **kw):
    """Every layer in order, each with its cache when decoding; returns
    (x, the new caches in :func:`init_caches`' layout)."""
    prefix, group = plan_groups(cfg)
    decode = caches is not None
    new_prefix = []
    for n, i in enumerate(prefix):
        spec = cfg.layer_spec(i)
        x, c, _ = _layer_apply(params["prefix_layers"][n], x, cfg, spec, spec.sliding_window,
                               cache=caches["prefix"][n] if decode else None,
                               decode=decode, make_cache=not decode, **kw)
        new_prefix.append(c)
    new_scan = None
    if group is not None:
        per_repeat = [[] for _ in group.specs]
        for r in range(group.n_repeats):
            for j, spec in enumerate(group.specs):
                x, c, _ = _layer_apply(
                    _repeat(params["scan_layers"][j], r), x, cfg, spec, spec.sliding_window,
                    cache=_repeat(caches["scan"][j], r) if decode else None,
                    decode=decode, make_cache=not decode, **kw)
                per_repeat[j].append(c)
        new_scan = [_stack(cs) for cs in per_repeat]
    return x, {"prefix": new_prefix, "scan": new_scan}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_capacity: int,
            moe_impl: str = "dispatch"):
    """Full-sequence prefill: (logits of the last position [B, 1, Vp],
    decode-ready caches)."""
    x = embed_tokens(params, tokens, cfg)
    x, caches = _run_layers(params, x, cfg, cache_len=cache_capacity, moe_impl=moe_impl)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x[:, -1:], cfg), caches


def decode_step(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
                moe_impl: str = "dispatch"):
    """One-token decode. tokens [B, 1] (or [B, 1, K]). Returns (logits, caches)."""
    def index_of(c):
        return c["index"] if "index" in c else c["mixer"]["index"]

    index0 = (index_of(caches["prefix"][0]) if caches["prefix"]
              else index_of(caches["scan"][0])[0])
    x = embed_tokens(params, tokens, cfg, position_offset=index0)
    x, new_caches = _run_layers(params, x, cfg, caches=caches, moe_impl=moe_impl)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), new_caches
