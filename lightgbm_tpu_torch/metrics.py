"""Evaluation metrics: ``binary_logloss``, ``auc`` and ``l2``.

Copies of the JAX package's host metrics (``lightgbm_tpu/metrics.py``);
they evaluate on numpy arrays, outside the training loop.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["binary_logloss", "auc", "l2", "METRICS"]


def _avg(values, weight):
    values = np.asarray(values, np.float64)
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


def l2(label, score, weight: Optional[np.ndarray] = None) -> float:
    return _avg((score - label) ** 2, weight)


def binary_logloss(label, score, weight: Optional[np.ndarray] = None
                   ) -> float:
    """``score`` is the probability."""
    p = np.clip(score, 1e-15, 1 - 1e-15)
    loss = -(label * np.log(p) + (1 - label) * np.log(1 - p))
    return _avg(loss, weight)


def auc(label, score, weight: Optional[np.ndarray] = None) -> float:
    """ROC AUC by rank-sum over sorted scores with tie handling
    (``binary_metric.hpp`` AUCMetric)."""
    label = np.asarray(label)
    score = np.asarray(score)
    if weight is None:
        weight = np.ones_like(label, dtype=np.float64)
    order = np.argsort(score, kind="mergesort")
    s, y, w = score[order], label[order], weight[order]
    pos = np.sum(w * (y > 0))
    neg = np.sum(w) - pos
    if pos <= 0 or neg <= 0:
        return 1.0
    # per unique score: area += tie_pos * (neg_below + tie_neg / 2)
    starts = np.concatenate([[0], np.nonzero(np.diff(s))[0] + 1])
    wp = np.where(y > 0, w, 0.0)
    wn = np.where(y > 0, 0.0, w)
    tie_pos = np.add.reduceat(wp, starts)
    tie_neg = np.add.reduceat(wn, starts)
    neg_below = np.cumsum(tie_neg) - tie_neg
    area = np.sum(tie_pos * (neg_below + tie_neg / 2.0))
    return float(area / (pos * neg))


METRICS = {"binary_logloss": binary_logloss, "auc": auc, "l2": l2}
