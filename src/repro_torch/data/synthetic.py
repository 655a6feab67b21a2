"""Synthetic volumetric batches, ported from ``repro/data/synthetic.py``.

The host numpy generators of the reference, kept line for line so the
same seed gives bit-equal batches:

* ``DoseTaskGenerator``: OpenKBP-like, a CT-like background, spherical
  PTV and OAR masks, and a dose field that is an analytic function of the
  geometry;
* ``SegTaskGenerator``: BraTS/PanSeg-like, multi-channel volumes with
  blob-shaped foreground classes.

Site heterogeneity shifts the geometry per site.  The reference's traced
generators (``traced_stacked_batches``) draw from JAX's PRNG and are not
ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


def _sphere_mask(shape, center, radius):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2)
    return (d2 <= radius ** 2).astype(np.float32)


@dataclass
class DoseTaskGenerator:
    """OpenKBP-like: CT + PTV + OAR masks -> analytic dose field.

    ``site_pools`` emulates the paper's non-IID protocol: smaller sites
    resample from fewer distinct cases.
    """

    volume: Tuple[int, int, int] = (32, 32, 32)
    num_oars: int = 2
    num_sites: int = 8
    heterogeneity: float = 0.0
    seed: int = 0
    site_pools: Optional[Tuple[int, ...]] = None

    @property
    def in_channels(self) -> int:
        return 1 + 1 + self.num_oars        # CT + PTV + OARs

    def sample(self, site: int, step: int, batch: int) -> Dict[str, np.ndarray]:
        if self.site_pools is not None:
            step = step % max(self.site_pools[site], 1)
        rng = np.random.default_rng(self.seed * 7919 + site * 101 + step)
        d, h, w = self.volume
        vol = np.zeros((batch, d, h, w, self.in_channels), np.float32)
        dose = np.zeros((batch, d, h, w, 1), np.float32)
        mask = np.zeros((batch, d, h, w, 1), np.float32)
        shift = self.heterogeneity * (site - self.num_sites / 2) / self.num_sites
        for b in range(batch):
            ct = rng.normal(0.0, 0.3, (d, h, w)).astype(np.float32)
            body = _sphere_mask((d, h, w), (d / 2, h / 2, w / 2), 0.45 * d)
            ct = ct * body
            center = np.array([d, h, w]) * (0.5 + shift + rng.uniform(-0.14, 0.14, 3))
            r_ptv = d * rng.uniform(0.06, 0.18)
            ptv = _sphere_mask((d, h, w), center, r_ptv)
            oars = []
            for k in range(self.num_oars):
                oc = center + np.array([0, (k + 1) * r_ptv * 2.2, 0]) \
                    * (1 if k % 2 == 0 else -1)
                oars.append(_sphere_mask((d, h, w), oc, r_ptv * 0.8))
            zz, yy, xx = np.meshgrid(*[np.arange(s) for s in (d, h, w)], indexing="ij")
            dist = np.sqrt((zz - center[0]) ** 2 + (yy - center[1]) ** 2
                           + (xx - center[2]) ** 2)
            field = 70.0 * np.exp(-np.maximum(dist - r_ptv, 0) / (0.15 * d))
            for o in oars:
                field = field * (1.0 - 0.35 * o)
            field = field * body
            vol[b, ..., 0] = ct
            vol[b, ..., 1] = ptv
            for k, o in enumerate(oars):
                vol[b, ..., 2 + k] = o
            dose[b, ..., 0] = field / 70.0
            mask[b, ..., 0] = body
        return {"volume": vol, "dose": dose, "mask": mask}

    def stacked_batches(self, step: int, local_steps: int, per_site_batch: int):
        """[S, K, B, ...] batches for one FL round (K = local steps)."""
        def one(s, k):
            return self.sample(s, step * local_steps + k, per_site_batch)
        sites = []
        for s in range(self.num_sites):
            ks = [one(s, k) for k in range(local_steps)]
            sites.append({k: np.stack([x[k] for x in ks]) for k in ks[0]})
        return {k: np.stack([s[k] for s in sites]) for k in sites[0]}


@dataclass
class SegTaskGenerator:
    """BraTS/PanSeg-like: channels -> voxel labels (blob classes).

    ``site_pools`` limits how many distinct cases a site owns: smaller
    sites recycle a smaller pool.
    """

    volume: Tuple[int, int, int] = (32, 32, 32)
    in_channels: int = 4
    num_classes: int = 4
    num_sites: int = 8
    heterogeneity: float = 0.0
    seed: int = 0
    site_pools: Optional[Tuple[int, ...]] = None

    def sample(self, site: int, step: int, batch: int) -> Dict[str, np.ndarray]:
        if self.site_pools is not None:
            step = step % max(self.site_pools[site], 1)
        rng = np.random.default_rng(self.seed * 104729 + site * 211 + step)
        d, h, w = self.volume
        vol = np.zeros((batch, d, h, w, self.in_channels), np.float32)
        labels = np.zeros((batch, d, h, w), np.int32)
        shift = self.heterogeneity * (site - self.num_sites / 2) / self.num_sites
        for b in range(batch):
            lab = np.zeros((d, h, w), np.int32)
            for c in range(1, self.num_classes):
                center = np.array([d, h, w]) * (0.5 + shift + rng.uniform(-0.15, 0.15, 3))
                r = d * rng.uniform(0.10, 0.20) / c
                lab = np.where(_sphere_mask((d, h, w), center, r) > 0, c, lab)
            base = rng.normal(0, 0.15, (d, h, w, self.in_channels)).astype(np.float32)
            for ch in range(self.in_channels):
                base[..., ch] += lab * (0.5 + 0.25 * ch)   # strong class signal
            vol[b] = base
            labels[b] = lab
        return {"volume": vol, "labels": labels}

    def stacked_batches(self, step: int, local_steps: int, per_site_batch: int):
        """[S, K, B, ...] batches for one FL round (K = local steps)."""
        sites = []
        for s in range(self.num_sites):
            ks = [self.sample(s, step * local_steps + k, per_site_batch)
                  for k in range(local_steps)]
            sites.append({k: np.stack([x[k] for x in ks]) for k in ks[0]})
        return {k: np.stack([s[k] for s in sites]) for k in sites[0]}
