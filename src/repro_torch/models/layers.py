"""Shared building blocks of the token models, ported from ``repro/models/layers.py``.

Every module is a pair of functions on plain tensors::

    params = <name>_init(generator, ..., device=device)
    y      = <name>_apply(params, x, ...)

Parameters are plain dicts of tensors with the reference's nesting, so
a reference tree converts leaf by leaf (``repro_torch.convert``).  Dense
weights are ``[d_in, d_out]`` and every projection is ``x @ W``, as in
the reference.

Initializers draw the reference's distributions from a
``torch.Generator`` (not JAX's streams: the numbers differ, the
distributions do not).  On the ``meta`` device they only allocate, which
is how :func:`repro_torch.models.transformer.count_params` counts a
398B-parameter model without memory.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _draws(device) -> bool:
    return torch.device(device).type != "meta"


def trunc_normal(gen, shape, scale: float, device, dtype=torch.float32) -> torch.Tensor:
    """Truncated standard normal on [-2, 2], times ``scale``."""
    t = torch.empty(shape, device=device, dtype=torch.float32)
    if _draws(device):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(scale)
    return t.to(dtype)


def normal(gen, shape, std: float, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, device=device, dtype=torch.float32)
    if _draws(device):
        t.normal_(0.0, std, generator=gen)
    return t.to(dtype)


def uniform(gen, shape, lo: float, hi: float, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, device=device, dtype=torch.float32)
    if _draws(device):
        t.uniform_(lo, hi, generator=gen)
    return t.to(dtype)


def dense_init(gen, d_in: int, d_out: int, device, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init for a [d_in, d_out] kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return trunc_normal(gen, (d_in, d_out), scale, device, dtype)


def embed_init(gen, vocab: int, d_model: int, device, dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, d_model), 0.02, device, dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), device=device, dtype=dtype)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS layer norm; statistics in fp32 whatever the input dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head normalization of the qk-norm variants (Qwen3/Gemma3).  As
    in the reference this is an RMS normalization (a mean of squares),
    not a division by the L2 norm."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding (half-dim)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x [..., L, H, D] at positions [..., L].

    Rotates the two halves of the head (``x[..., :D/2]`` against
    ``x[..., D/2:]``), as the reference's code does (its docstring says
    interleaved pairs; the code is what counts).  fp32 inside."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)                  # [D/2]
    ang = positions[..., :, None].float() * inv                # [..., L, D/2]
    sin = torch.sin(ang)[..., :, None, :]                      # [..., L, 1, D/2]
    cos = torch.cos(ang)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _sinusoid(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Rows of the sinusoidal table at fp32 positions ``pos`` [L] -> [L, d]."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=pos.device)
    ang = pos[:, None] / torch.pow(torch.tensor(10000.0, device=pos.device), dim / d_model)
    table = torch.zeros((pos.shape[0], d_model), dtype=torch.float32, device=pos.device)
    table[:, 0::2] = torch.sin(ang)
    table[:, 1::2] = torch.cos(ang)
    return table


def sinusoidal_positions(length: int, d_model: int, device=None,
                         dtype=torch.float32) -> torch.Tensor:
    """Classic transformer sinusoidal table (MusicGen-style)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)
    return _sinusoid(pos, d_model).to(dtype)


# ---------------------------------------------------------------------------
# Feed-forward networks
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {
        "gelu": gelu,
        "silu": F.silu,
        "relu_sq": lambda x: torch.square(F.relu(x)),
    }[name]


def mlp_init(gen, d_model: int, d_ff: int, activation: str = "swiglu", device=None,
             dtype=torch.float32):
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d_model, d_ff, device, dtype),
            "w_up": dense_init(gen, d_model, d_ff, device, dtype),
            "w_down": dense_init(gen, d_ff, d_model, device, dtype),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff, device, dtype),
        "w_down": dense_init(gen, d_ff, d_model, device, dtype),
    }


def mlp_apply(params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif activation == "geglu":
        h = gelu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = _act(activation)(x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Token shift (RWKV)
# ---------------------------------------------------------------------------


def token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one: y[t] = x[t-1]; y[0] = last or 0.

    x: [B, L, D]; ``last`` [B, D] is the previous segment's final token.
    """
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)
