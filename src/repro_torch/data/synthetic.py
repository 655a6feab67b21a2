"""Synthetic batches, ported from ``repro/data/synthetic.py``.

The host numpy generators of the reference, kept line for line so the
same seed gives bit-equal batches:

* ``TokenTaskGenerator``: language-model streams from a site-specific
  markov rule over the vocabulary (``heterogeneity`` shifts each site's
  transition bias);
* ``DoseTaskGenerator``: OpenKBP-like, a CT-like background, spherical
  PTV and OAR masks, and a dose field that is an analytic function of the
  geometry;
* ``SegTaskGenerator``: BraTS/PanSeg-like, multi-channel volumes with
  blob-shaped foreground classes.

Site heterogeneity shifts the geometry per site.

Each also has the reference's on-device twin, ``traced_stacked_batches(key,
local_steps, per_site_batch)``: the same geometry and laws drawn from JAX's
threefry stream (:mod:`repro_torch.core.prng`) on the key's device, as
``[S, K, B, ...]`` tensors.  The case keys are ``split(key, S*K*B)`` in
``[S, K, B]`` order, and each case splits its own key as the reference's
does, so one key gives the reference's cases: the masks and labels bit for
bit, the float channels within the normals' and ``exp``'s few ulp.  The
cases are drawn in groups of at most ``CASE_VOXELS`` voxels, which bounds
the peak memory and changes no value.  The streams differ from the host
generators' (numpy's), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

# voxels of the cases drawn at once by the traced generators (at 128^3, two
# cases)
CASE_VOXELS = 1 << 22


def _sphere_mask(shape, center, radius):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2)
    return (d2 <= radius ** 2).astype(np.float32)


def _f32(x: float) -> float:
    """A Python constant rounded to fp32, as JAX rounds a weakly typed one."""
    return float(np.float32(x))


def _consts(values, device) -> torch.Tensor:
    """An fp32 vector of Python constants, filled on ``device`` (no copy
    from the host, so a draw can be captured in a CUDA graph)."""
    return torch.cat([torch.full((1,), _f32(v), dtype=torch.float32, device=device)
                      for v in values])


@dataclass
class TokenTaskGenerator:
    """Markov-ish token streams: ``t_{i+1} = (31 t_i + 17 + noise + bias) %
    vocab``, the noise uniform on ``[0, max(vocab // 8, 8))`` and the bias
    ``site_offsets[site] * heterogeneity``."""

    vocab_size: int
    num_sites: int
    heterogeneity: float = 0.0          # 0 = IID
    num_codebooks: int = 1
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # each site draws from a site-biased unigram prior + shared bigram rule
        self.site_offsets = rng.integers(0, self.vocab_size, self.num_sites)

    def _site_rng(self, site: int, step: int):
        return np.random.default_rng(
            (self.seed * 1000003 + site * 10007 + step) % (2 ** 63))

    def sample(self, site: int, step: int, batch: int, seq_len: int) -> np.ndarray:
        """int32 ``[batch, seq_len]`` (``[..., num_codebooks]`` with
        codebooks) from the site's stream at ``step``."""
        rng = self._site_rng(site, step)
        shape = (batch, seq_len, self.num_codebooks) if self.num_codebooks > 1 \
            else (batch, seq_len)
        v = self.vocab_size
        base = rng.integers(0, v, (shape[0],) + shape[2:] if len(shape) > 2 else (shape[0],))
        toks = np.zeros(shape, dtype=np.int32)
        cur = base
        bias = int(self.site_offsets[site] * self.heterogeneity)
        # narrow noise keeps the bigram task learnable (entropy ~ln(v/8));
        # heterogeneity shifts each site's transition BIAS, not the noise
        width = max(v // 8, 8)
        for i in range(seq_len):
            drift = (cur * 31 + 17) % v
            noise = rng.integers(0, width, drift.shape)
            cur = (drift + noise + bias) % v
            if len(shape) > 2:
                toks[:, i, :] = cur
            else:
                toks[:, i] = cur
        return toks

    def stacked_batches(self, step: int, local_steps: int, per_site_batch: int,
                        seq_len: int) -> Dict[str, np.ndarray]:
        """[S, K, B, L(, C)] token batches for one FL round."""
        out = np.stack([
            np.stack([self.sample(s, step * local_steps + k, per_site_batch, seq_len)
                      for k in range(local_steps)])
            for s in range(self.num_sites)])
        return {"tokens": out}

    def traced_stacked_batches(self, key: torch.Tensor, local_steps: int,
                               per_site_batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
        """int32 [S, K, B, L(, C)] batches drawn on the key's device from the
        reference's threefry stream: ``split(key)`` into a start key and a
        step key, the start tokens ``randint(start, [S, K, B(, C)], 0, v)``,
        and step i's noise ``randint(split(step key, L)[i], ..., 0, width)``:
        the reference's jitted draw bit for bit (its streams differ from the
        numpy generator's, as in the reference)."""
        v = self.vocab_size
        width = max(v // 8, 8)
        shape = (self.num_sites, local_steps, per_site_batch)
        if self.num_codebooks > 1:
            shape = shape + (self.num_codebooks,)
        bias = torch.from_numpy((self.site_offsets * self.heterogeneity).astype(np.int32))
        bias = bias.to(device=key.device, dtype=torch.int64).reshape(
            (-1,) + (1,) * (len(shape) - 1))
        k_base, k_steps = prng.split(key)
        cur = prng.randint(k_base, shape, 0, v)
        noise = prng.randint(prng.split(k_steps, seq_len), shape, 0, width)   # [L, *shape]
        toks = torch.empty((seq_len,) + shape, dtype=torch.int32, device=key.device)
        for i in range(seq_len):
            cur = ((cur * 31 + 17) % v + noise[i] + bias) % v
            toks[i] = cur
        return {"tokens": toks.movedim(0, 3).contiguous()}


class _Traced:
    """What the traced generators share: the voxel grid and the per-site
    shifts on one device."""

    def __init__(self, volume, num_sites: int, heterogeneity: float, device):
        d, h, w = volume
        axes = [torch.arange(n, dtype=torch.float32, device=device) for n in volume]
        self.grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))       # [3, d, h, w]
        self.dims = _consts((d, h, w), device)
        s = num_sites
        self.shifts = (torch.arange(s, dtype=torch.float32, device=device) - _f32(s / 2)) \
            * _f32(heterogeneity) / _f32(s)

    def d2(self, centers: torch.Tensor) -> torch.Tensor:
        """Squared distances [G, d, h, w] of every voxel to each centre [G, 3],
        summed over the axes in order."""
        g = self.grid[None]
        c = centers[:, :, None, None, None]
        sq = (g - c) * (g - c)
        return (sq[:, 0] + sq[:, 1]) + sq[:, 2]

    def centers(self, k: torch.Tensor, shift: torch.Tensor, lo: float, hi: float):
        """``dims * (0.5 + shift + U(lo, hi)^3)`` for each key of ``k`` [G, 2]."""
        u = prng.uniform_fma_from_bits(prng.keys_bits(k, (3,)), lo, hi)
        return self.dims * ((0.5 + shift[:, None]) + u)


def _stacked(cases, key: torch.Tensor, num_sites: int, local_steps: int, per_site_batch: int,
             case_voxels: int) -> Dict[str, torch.Tensor]:
    """``cases(keys, sites)`` for every case key of ``split(key, S*K*B)``,
    in groups of at most ``CASE_VOXELS // case_voxels`` cases, laid out
    ``[S, K, B, ...]``."""
    n = num_sites * local_steps * per_site_batch
    keys = prng.split(key, n)
    sites = torch.arange(n, device=key.device) // (local_steps * per_site_batch)
    group = max(1, CASE_VOXELS // case_voxels)
    out: Dict[str, torch.Tensor] = {}
    for i in range(0, n, group):
        for name, part in cases(keys[i:i + group], sites[i:i + group]).items():
            if name not in out:
                out[name] = torch.empty((n,) + part.shape[1:], dtype=part.dtype,
                                        device=key.device)
            out[name][i:i + part.shape[0]] = part
    lead = (num_sites, local_steps, per_site_batch)
    return {name: x.view(*lead, *x.shape[1:]) for name, x in out.items()}


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

    def traced_stacked_batches(self, key: torch.Tensor, local_steps: int,
                               per_site_batch: int) -> Dict[str, torch.Tensor]:
        """[S, K, B, ...] dose batches drawn from ``key`` on its device, the
        reference's on-device twin of :meth:`stacked_batches` (the same
        geometry family, dose law and site shift; ``site_pools`` stays on
        the host)."""
        d, h, w = self.volume
        return _stacked(self.traced_cases, key, self.num_sites, local_steps, per_site_batch,
                        d * h * w)

    def traced_cases(self, keys: torch.Tensor, sites: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The cases of ``keys`` [G, 2] at ``sites`` [G], as
        :meth:`traced_stacked_batches` draws each: a case splits its key into
        (CT noise, centre, radius).  [G, ...] tensors on the keys' device."""
        d, h, w = self.volume
        t = _Traced(self.volume, self.num_sites, self.heterogeneity, keys.device)
        body = (t.d2((t.dims / 2)[None])[0] <= _f32((0.45 * d) * (0.45 * d))).float()
        sub = prng.fold_in(keys[:, None], torch.arange(3, device=keys.device))   # [G, 3, 2]
        shift = t.shifts[sites]
        ct = prng.normal_from_bits(prng.keys_bits(sub[:, 0], (d, h, w))) * _f32(0.3) * body
        center = t.centers(sub[:, 1], shift, -0.14, 0.14)
        r_ptv = prng.uniform_fma_from_bits(prng.keys_bits(sub[:, 2], ()), 0.06, 0.18) * d
        r4 = r_ptv[:, None, None, None]
        d2 = t.d2(center)
        chans = [ct, (d2 <= r4 * r4).float()]
        for j in range(self.num_oars):
            off = _consts((0.0, (j + 1) * 2.2, 0.0), keys.device)
            oc = center + off[None] * r_ptv[:, None] * (1.0 if j % 2 == 0 else -1.0)
            rr = r4 * _f32(0.8)
            chans.append((t.d2(oc) <= rr * rr).float())
        dist = torch.sqrt(d2)
        field = torch.exp(-torch.clamp_min(dist - r4, 0.0) / _f32(0.15 * d)) * _f32(70.0)
        for o in chans[2:]:
            field = field * (1.0 - o * _f32(0.35))
        field = field * body
        return {"volume": torch.stack(chans, dim=-1), "dose": (field / _f32(70.0))[..., None],
                "mask": body.expand(keys.shape[0], d, h, w)[..., None]}


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

    def traced_stacked_batches(self, key: torch.Tensor, local_steps: int,
                               per_site_batch: int) -> Dict[str, torch.Tensor]:
        """[S, K, B, ...] segmentation batches drawn from ``key`` on its
        device, the reference's on-device twin of :meth:`stacked_batches`
        (the same blob-class law and site shift; ``site_pools`` stays on the
        host)."""
        d, h, w = self.volume
        return _stacked(self.traced_cases, key, self.num_sites, local_steps, per_site_batch,
                        d * h * w * self.in_channels)

    def traced_cases(self, keys: torch.Tensor, sites: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The cases of ``keys`` [G, 2] at ``sites`` [G], as
        :meth:`traced_stacked_batches` draws each: a case splits its key into
        the noise key and one key a class, each of which splits into
        (centre, radius); the noise is drawn at its ``[d, h, w, C]`` shape,
        so each element's counter is its index there."""
        d, h, w = self.volume
        dev = keys.device
        t = _Traced(self.volume, self.num_sites, self.heterogeneity, dev)
        gain = _consts([0.5 + 0.25 * c for c in range(self.in_channels)], dev)
        sub = prng.fold_in(keys[:, None], torch.arange(self.num_classes + 1, device=dev))
        shift = t.shifts[sites]
        lab = torch.zeros((keys.shape[0], d, h, w), dtype=torch.int32, device=dev)
        for c in range(1, self.num_classes):
            kc = prng.fold_in(sub[:, c, None], torch.arange(2, device=dev))    # [G, 2, 2]
            center = t.centers(kc[:, 0], shift, -0.15, 0.15)
            r = prng.uniform_fma_from_bits(prng.keys_bits(kc[:, 1], ()), 0.10, 0.20) * d / c
            r4 = r[:, None, None, None]
            lab = torch.where(t.d2(center) <= r4 * r4, c, lab)
        noise = prng.normal_from_bits(prng.keys_bits(sub[:, 0], (d, h, w, self.in_channels)))
        return {"volume": noise * _f32(0.15) + lab[..., None].float() * gain, "labels": lab}
