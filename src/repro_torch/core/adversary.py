"""Deterministic Byzantine adversary plans, ported from ``repro/core/adversary.py``.

An :class:`AdversaryPlan` makes ``f`` of the job's sites malicious and
perturbs what they contribute at the site-update seam: the rows of the
round loop's ``[S, N]`` buffer that malicious ACTIVE sites expose to
aggregation, between local training and ``post_exchange``.  Because
``post_exchange`` overwrites every active row with the new global, the
perturbation never persists into the next round, so the port perturbs
the buffer in place.

Which sites are malicious is a pure function of ``(seed, num_sites)``,
drawn from numpy exactly as the reference draws it, so the sets are
bit-equal.

Spec grammar (the last field is the malicious-site count f)::

    sign_flip:f      f sites upload -params
    scale:c:f        f sites upload c*params
    noise:s:f        f sites upload params + s*N(0,1)   (not ported)
    label_flip:f     f sites train on corrupted targets (floats negated,
                     int targets reversed along the last axis)

The noise attack draws from a JAX threefry key chain; bit-equal noise
needs a port of that generator, so it raises :class:`~repro_torch.NotPorted`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import NotPorted

# keys of a batch dict that count as training targets for label_flip
TARGET_KEYS = ("dose", "labels", "tokens")

_SELECT_SALT = 104729   # site-selection stream, disjoint from data/DP seeds


@dataclasses.dataclass(frozen=True)
class AdversaryPlan:
    """Seeded selection of f malicious sites + the perturbation they apply."""
    kind: str           # sign_flip | scale | noise | label_flip
    f: int              # number of malicious sites
    param: float = 0.0  # c for scale, s for noise
    seed: int = 0

    @property
    def flips_labels(self) -> bool:
        return self.kind == "label_flip"

    @property
    def flips_params(self) -> bool:
        return self.kind in ("sign_flip", "scale", "noise")

    def malicious_mask(self, num_sites: int) -> np.ndarray:
        """[S] bool: the fixed malicious set, a pure function of
        ``(seed, num_sites)``."""
        mask = np.zeros((num_sites,), bool)
        if self.f <= 0:
            return mask
        rng = np.random.default_rng((self.seed + _SELECT_SALT, num_sites))
        idx = rng.choice(num_sites, size=min(self.f, num_sites), replace=False)
        mask[idx] = True
        return mask

    def perturb_rows(self, flat: torch.Tensor, mask: np.ndarray) -> None:
        """Perturb the rows of the [S, N] buffer ``flat`` where ``mask`` is
        set, in place.  The caller passes ``malicious & active``, so an
        inactive malicious site keeps its clean local state."""
        if self.kind == "noise":
            raise NotPorted("adversary", f"noise:{self.param:g}:{self.f}",
                            "sign_flip, scale, label_flip")
        for i in np.flatnonzero(mask):
            if self.kind == "sign_flip":
                flat[i].neg_()
            elif self.kind == "scale":
                flat[i].mul_(float(np.float32(self.param)))   # p * fp32(c)

    def perturb_batches(self, batches: Dict[str, torch.Tensor],
                        mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """label_flip on the masked sites of a site-stacked batch dict
        ([S, ...] leaves): float targets negate, integer targets reverse
        along the last axis.  Other keys pass through."""
        out = dict(batches)
        for key in TARGET_KEYS:
            if key in out:
                v = out[key]
                m = torch.as_tensor(mask, device=v.device).reshape((-1,) + (1,) * (v.dim() - 1))
                out[key] = torch.where(m, _flip_target(v), v)
        return out


def _flip_target(v: torch.Tensor) -> torch.Tensor:
    if v.is_floating_point():
        return -v
    return torch.flip(v, dims=(-1,))


def parse_adversary(spec, seed: int = 0) -> Optional[AdversaryPlan]:
    """``sign_flip:f | label_flip:f | scale:c:f | noise:s:f`` -> plan.

    ``None``/empty/``"none"`` -> no adversary.  Accepts a parsed plan
    (idempotent; the seed argument is ignored then)."""
    if spec is None or isinstance(spec, AdversaryPlan):
        return spec
    text = str(spec).strip()
    if not text or text == "none":
        return None
    parts = text.split(":")
    kind = parts[0].strip()
    try:
        if kind in ("sign_flip", "label_flip"):
            if len(parts) != 2 or int(parts[1]) < 1:
                raise ValueError
            return AdversaryPlan(kind, f=int(parts[1]), seed=seed)
        if kind in ("scale", "noise"):
            if len(parts) != 3 or int(parts[2]) < 1:
                raise ValueError
            return AdversaryPlan(kind, f=int(parts[2]), param=float(parts[1]), seed=seed)
    except ValueError:
        pass
    raise ValueError(f"unknown adversary {text!r} (expected sign_flip:f | "
                     "label_flip:f | scale:c:f | noise:s:f)")
