"""DP-SGD: per-site / per-example clipping + Gaussian noise, ported from
``repro/privacy/dp.py``.

The noise stream is a pure function of ``(dp seed, round, site, step)``:
each key folds the round counter the round loop carries
(``fl_state["round"]``), the site's global index and the local step into
one base key, through the port of JAX's threefry stream
(:mod:`repro_torch.core.prng`).  So the stream is the same on every
stacked engine, on the socket sites and across a resume (a resumed state
restores the round counter), and it is the reference's: each leaf's noise
is drawn at its reference shape (conv weights DHWIO) from the leaf's own
subkey, and lands in the port's layout (OIDHW).

Two clipping granularities (``mode``):

  * ``per-site``    -- the site's whole-batch gradient is clipped to
                      ``clip`` and noised with ``N(0, (sigma*clip)^2)``;
  * ``per-example`` -- each example's gradient (``torch.func.vmap`` of
                      ``torch.func.grad``) is clipped to ``clip``, the
                      clipped sum noised with ``N(0, (sigma*clip)^2)`` and
                      averaged over the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import prng
from repro_torch.tree import tree_leaves, tree_unflatten

#: Stream-domain tag folded into the base key (the reference's: its
#: on-device data stream folds tag 7).
DP_STREAM_TAG = 13

_MODES = ("per-site", "per-example")


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """DP-SGD knobs.  The mechanism is on iff ``clip > 0``; sigma = 0 then
    means clip-only (no formal guarantee, epsilon = inf)."""

    clip: float
    noise_multiplier: float = 0.0
    delta: float = 1e-5
    mode: str = "per-site"
    seed: int = 0                      # noise-stream seed (the job seed)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"dp mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.noise_multiplier < 0:
            raise ValueError("dp noise multiplier must be >= 0")
        if self.noise_multiplier > 0 and self.clip <= 0:
            raise ValueError("DP noise needs a finite sensitivity: set "
                             "dp_clip > 0 alongside dp_noise_multiplier")


def round_key(cfg: DPConfig, round_index: int) -> torch.Tensor:
    """Base noise key of one round (a CPU key)."""
    return prng.fold_in(prng.fold_in(prng.key(cfg.seed), DP_STREAM_TAG), round_index)


def site_step_key(rkey: torch.Tensor, site_index: int, step_index: int) -> torch.Tensor:
    """One (site, local step) slot of the round's noise stream; ``site_index``
    is the site's global id."""
    return prng.fold_in(prng.fold_in(rkey, site_index), step_index)


class LeafStream:
    """Where each element of a flat ``[N]`` buffer of leaves ``shapes``
    (the port's layout) sits in the reference's draws: ``leaf`` [N] its
    leaf's index, ``counter`` [N] its flat index in the leaf's reference
    order (conv weights DHWIO).  Built once per layout and device."""

    _CACHE: Dict[Any, "LeafStream"] = {}

    def __init__(self, shapes, device: torch.device):
        leaf, counter = [], []
        for i, shape in enumerate(shapes):
            n = int(np.prod(shape, dtype=np.int64))
            order = convert.reference_order(shape)
            pos = np.arange(n, dtype=np.int64)
            if order is not None:     # the reference index of each port element
                pos = np.empty(n, np.int64)
                pos[np.arange(n).reshape(shape).transpose(order).reshape(-1)] = np.arange(n)
            leaf.append(np.full(n, i, np.int64))
            counter.append(pos)
        self.num_leaves = len(shapes)
        self.leaf = torch.from_numpy(np.concatenate(leaf)).to(device)
        self.counter = torch.from_numpy(np.concatenate(counter)).to(device)

    @classmethod
    def of(cls, shapes, device) -> "LeafStream":
        key = (tuple(tuple(s) for s in shapes), str(torch.device(device)))
        stream = cls._CACHE.get(key)
        if stream is None:
            stream = cls._CACHE[key] = cls(shapes, torch.device(device))
        return stream

    def normal(self, keys: torch.Tensor) -> torch.Tensor:
        """[N] fp32: leaf ``i``'s ``jax.random.normal(keys[i], ref_shape)``
        laid out in the port's order (``keys`` [L, 2], any device)."""
        keys = keys.to(self.leaf.device)
        return prng.normal_from_bits(prng.bits_at(keys[:, 0][self.leaf], keys[:, 1][self.leaf],
                                                  self.counter))


def leaf_noise(key: torch.Tensor, shapes, device) -> torch.Tensor:
    """One standard-normal draw per leaf of ``shapes``, each leaf from its
    own subkey ``split(key, L)[i]``, as one flat [N] fp32 buffer in the
    port's layout."""
    stream = LeafStream.of(shapes, device)
    return stream.normal(prng.split(key, stream.num_leaves))


def gaussian_noise_like(key: torch.Tensor, tree: Any, stddev: float) -> Any:
    """A tree of ``N(0, stddev^2)`` fp32 noise shaped like ``tree`` (the
    port's layout), one subkey per leaf in ``tree_leaves`` order: the
    reference's draws for the same tree in its layout."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    flat = leaf_noise(key, shapes, leaves[0].device) * _f32(stddev)
    return tree_unflatten(tree, [t.view(sh) for t, sh in zip(
        torch.split(flat, [int(np.prod(s, dtype=np.int64)) for s in shapes]), shapes)])


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a weak-typed scalar meets an fp32 array."""
    return float(np.float32(x))


def dp_gradients(loss_fn: Callable, row: torch.Tensor, layout, batch: Dict[str, torch.Tensor],
                 key: torch.Tensor, cfg: DPConfig) -> Tuple[torch.Tensor, torch.Tensor, Dict,
                                                            torch.Tensor]:
    """DP-SGD gradient of ``loss_fn(params, batch) -> (loss, metrics)`` at
    the flat parameter row ``row`` [N] (``layout`` a
    :class:`~repro_torch.core.agg_engine.RavelLayout`).

    Returns ``(grad [N], loss, metrics, grad_norm)``: ``grad`` clipped (and
    noised when sigma > 0); ``grad_norm`` the pre-clip norm (per-site) or
    the mean per-example norm (per-example)."""
    from repro_torch.optim import clip_by_global_norm
    if cfg.mode == "per-site":
        params, leaves = layout.trainable(row)
        loss, metrics = loss_fn(params, batch)
        g = layout.flat_grad(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))
        g, gnorm = clip_by_global_norm(g, cfg.clip)
        stddev = cfg.noise_multiplier * cfg.clip
    else:
        views = [v.detach() for v in layout.views(row)]
        with torch.no_grad():         # loss and metrics from one plain forward
            loss, metrics = loss_fn(tree_unflatten(layout.treedef, views), batch)

        def one(leaves, ex):
            exb = {k: v[None] for k, v in ex.items()}
            return loss_fn(tree_unflatten(layout.treedef, leaves), exb)[0]

        per_ex = torch.func.vmap(torch.func.grad(one), in_dims=(None, 0))(views, batch)
        bsz = per_ex[0].shape[0]
        grads = torch.cat([x.reshape(bsz, -1) for x in per_ex], 1)
        norms = torch.sqrt(torch.sum(torch.square(grads), 1))
        scale = torch.clamp(cfg.clip / (norms + 1e-9), max=1.0)
        g = torch.sum(grads * scale[:, None], 0) / bsz
        gnorm = torch.mean(norms)
        # noise calibrated to the clipped sum's sensitivity, then averaged
        stddev = cfg.noise_multiplier * cfg.clip / bsz
    if cfg.noise_multiplier > 0:
        g = g + leaf_noise(key, layout.shapes, g.device) * _f32(stddev)
    return g, loss.detach(), metrics, gnorm
