"""Clustering quality metrics: accuracy up to label permutation, as the
paper reports in Table 1 / Figure 1 (copy of ``repro/utils/metrics.py``)."""
from __future__ import annotations

import numpy as np


def confusion(pred, true, k: int) -> np.ndarray:
    """(k, k) confusion counts over valid (label >= 0) entries."""
    pred = np.asarray(pred).reshape(-1)
    true = np.asarray(true).reshape(-1)
    m = (pred >= 0) & (true >= 0)
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (pred[m], true[m]), 1)
    return cm


def clustering_accuracy(pred, true, k: int) -> float:
    """Accuracy under the best label permutation (Hungarian matching)."""
    from scipy.optimize import linear_sum_assignment
    cm = confusion(pred, true, k)
    rows, cols = linear_sum_assignment(-cm)
    total = cm.sum()
    return float(cm[rows, cols].sum() / max(total, 1))
