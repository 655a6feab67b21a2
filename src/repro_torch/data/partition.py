"""Site partitioning, ported from ``repro/data/partition.py``: IID and non-IID
splits (paper §III.A.1, Figs 6/10/13).  Plain numpy, kept line for line so
the same seed gives the same partition.

The OpenKBP dataset carries no site metadata, so the paper *simulates*
federation by partitioning cases across 8 sites: evenly (IID) or with a
skewed case-count distribution (non-IID).  BraTS'21 and PanSeg carry real
site identifiers; their per-site case counts (Figs 10/13) are encoded
here so the benchmarks reproduce the same imbalance.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

# Paper Fig 6: 200 training / 40 validation cases over 8 sites.
OPENKBP_IID_TRAIN = (25,) * 8
OPENKBP_IID_VAL = (5,) * 8
# non-IID: skewed counts (largest site 48, smallest 12 — §III.A.4 cites
# site 0 = 48 and site 7 = 12 explicitly; interior sites interpolated).
OPENKBP_NONIID_TRAIN = (48, 36, 30, 24, 20, 16, 14, 12)
OPENKBP_NONIID_VAL = (10, 7, 6, 5, 4, 3, 3, 2)

# BraTS 2021 (Fig 10): 227 cases over 8 real sites, ~70/10/20 split per site.
BRATS_SITE_CASES = (52, 44, 35, 28, 24, 18, 14, 12)
# PanSeg (Fig 13): 384 T1 MRI over 5 institutions.
PANSEG_SITE_CASES = (110, 92, 74, 60, 48)

assert sum(OPENKBP_NONIID_TRAIN) == 200
assert sum(OPENKBP_IID_TRAIN) == 200
assert sum(BRATS_SITE_CASES) == 227
assert sum(PANSEG_SITE_CASES) == 384


def partition_indices(num_cases: int, site_counts: Sequence[int],
                      seed: int = 0) -> List[np.ndarray]:
    """Randomly partition ``num_cases`` indices into per-site groups."""
    assert sum(site_counts) <= num_cases, (sum(site_counts), num_cases)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_cases)
    out, ofs = [], 0
    for c in site_counts:
        out.append(np.sort(perm[ofs: ofs + c]))
        ofs += c
    return out


def dirichlet_label_partition(labels: np.ndarray, num_sites: int,
                              alpha: float = 0.5, seed: int = 0) -> List[np.ndarray]:
    """Label-skew non-IID partitioning (Dirichlet), the standard FL
    heterogeneity protocol for classification-style data."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    site_idx: List[list] = [[] for _ in range(num_sites)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_sites)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for s, part in enumerate(np.split(idx, cuts)):
            site_idx[s].extend(part.tolist())
    return [np.sort(np.array(s, dtype=np.int64)) for s in site_idx]
