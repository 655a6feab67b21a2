"""Evaluation metrics from the paper's three use cases, ported from
``repro/metrics/scores.py``.  Plain numpy, kept line for line.

* dose score / DVH score — OpenKBP Challenge metrics (§III.A.2): lower
  is better.  Dose score = masked voxel MAE; DVH score = mean |Δ| over
  DVH summary statistics (D99/D50/D1 per ROI) between predicted and true
  dose.
* DSC — Dice similarity coefficient (§III.B.2 / §III.C.2).
* one-way ANOVA — the robustness test used for Fig 15 (p = 0.9097),
  implemented from first principles on numpy (F statistic + p-value via
  the regularized incomplete beta function).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dose_score(pred: np.ndarray, true: np.ndarray, mask: np.ndarray) -> float:
    """Masked voxel-wise MAE (OpenKBP dose score)."""
    m = mask.astype(bool)
    return float(np.abs(pred[m] - true[m]).mean())


def _dvh_stats(dose: np.ndarray, roi: np.ndarray) -> np.ndarray:
    vox = dose[roi.astype(bool)]
    if vox.size == 0:
        return np.zeros(3)
    return np.percentile(vox, [1, 50, 99])      # D99, D50, D1 (dose-at-volume)


def dvh_score(pred: np.ndarray, true: np.ndarray, rois: Sequence[np.ndarray]) -> float:
    """Mean |Δ| of DVH summary statistics over ROIs (OpenKBP DVH score)."""
    diffs: List[float] = []
    for roi in rois:
        d = np.abs(_dvh_stats(pred, roi) - _dvh_stats(true, roi))
        diffs.extend(d.tolist())
    return float(np.mean(diffs)) if diffs else 0.0


def dice_coefficient(pred_labels: np.ndarray, true_labels: np.ndarray,
                     num_classes: int, ignore_background: bool = True) -> float:
    """Mean DSC over (foreground) classes."""
    scores = []
    start = 1 if ignore_background else 0
    for c in range(start, num_classes):
        p = pred_labels == c
        t = true_labels == c
        denom = p.sum() + t.sum()
        if denom == 0:
            continue
        scores.append(2.0 * np.logical_and(p, t).sum() / denom)
    return float(np.mean(scores)) if scores else 1.0


# --- ANOVA (no scipy available) --------------------------------------------


def _betacf(a, b, x, itmax=200, eps=3e-9):
    am, bm, az = 1.0, 1.0, 1.0
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    bz = 1.0 - qab * x / qap
    for m in range(1, itmax + 1):
        em = float(m)
        tem = em + em
        d = em * (b - m) * x / ((qam + tem) * (a + tem))
        ap = az + d * am
        bp = bz + d * bm
        d = -(a + em) * (qab + em) * x / ((a + tem) * (qap + tem))
        app = ap + d * az
        bpp = bp + d * bz
        aold = az
        am, bm = ap / bpp, bp / bpp
        az, bz = app / bpp, 1.0
        if abs(az - aold) < eps * abs(az):
            return az
    return az


def _betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0:
        return 0.0
    if x >= 1:
        return 1.0
    from math import exp, lgamma, log
    lbeta = lgamma(a + b) - lgamma(a) - lgamma(b) + a * log(x) + b * log(1 - x)
    bt = exp(lbeta)
    if x < (a + 1) / (a + b + 2):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1 - x) / b


def one_way_anova(groups: Sequence[np.ndarray]):
    """F statistic and p-value for k independent groups (Fig 15's test)."""
    groups = [np.asarray(g, dtype=np.float64) for g in groups if len(g) > 0]
    k = len(groups)
    n = sum(len(g) for g in groups)
    grand = np.concatenate(groups).mean()
    ss_between = sum(len(g) * (g.mean() - grand) ** 2 for g in groups)
    ss_within = sum(((g - g.mean()) ** 2).sum() for g in groups)
    df1, df2 = k - 1, n - k
    if df1 <= 0 or df2 <= 0 or ss_within == 0:
        return 0.0, 1.0
    f = (ss_between / df1) / (ss_within / df2)
    # p = P(F_{df1,df2} > f) = I_{df2/(df2+df1 f)}(df2/2, df1/2)
    p = _betainc(df2 / 2.0, df1 / 2.0, df2 / (df2 + df1 * f))
    return float(f), float(min(max(p, 0.0), 1.0))
