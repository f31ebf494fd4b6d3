"""The scikit-learn metrics that the analysis uses, in numpy.  New in the
port: the JAX package calls sklearn (``uncertainty.py``,
``analysis/plots.py``), which the card's machine does not have.  Each
function follows sklearn 1.9's binary, unweighted code path
(``metrics/_ranking.py``, ``calibration.py``), with its results for one-class
labels; ``tests/test_torch_uncertainty.py`` holds them against sklearn.

- roc_curve                 <- sklearn.metrics.roc_curve (drop_intermediate)
- precision_recall_curve    <- sklearn.metrics.precision_recall_curve
- auc                       <- sklearn.metrics.auc
- roc_auc_score             <- sklearn.metrics.roc_auc_score (binary)
- average_precision_score   <- sklearn.metrics.average_precision_score (binary)
- calibration_curve         <- sklearn.calibration.calibration_curve (uniform)

Labels are 0/1 (bool, int or float); the positive label is 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _labels(y_true) -> np.ndarray:
    y = np.asarray(y_true).reshape(-1)
    if not np.isin(np.unique(y), (0, 1)).all():
        raise ValueError(f"labels must be 0/1, got {np.unique(y)[:5]}")
    return y == 1


def _confusion_at_thresholds(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at each distinct score, scores descending."""
    y = _labels(y_true)
    s = np.asarray(y_score).reshape(-1)
    if y.shape != s.shape:
        raise ValueError(f"{y.size} labels for {s.size} scores")
    if not np.isfinite(s).all():
        raise ValueError("scores must be finite")
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order]
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, s[idx]


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (fpr, tpr, thresholds), collinear points dropped, (0, 0) first."""
    fps, tps, thresholds = _confusion_at_thresholds(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (precision, recall, thresholds), recall decreasing, ending (1, 0)."""
    fps, tps, thresholds = _confusion_at_thresholds(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1]


def auc(x, y) -> float:
    """Trapezoidal area under y(x), x monotone either way."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] < 2:
        raise ValueError(f"at least 2 points are needed to compute an area, got {x.shape[0]}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * np.trapezoid(y, x))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve; NaN when only one class is present."""
    if np.unique(np.asarray(y_true)).size != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def average_precision_score(y_true, y_score) -> float:
    """The step-function integral of the precision-recall curve."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def calibration_curve(y_true, y_prob, n_bins: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """-> (fraction of positives, mean predicted probability) of the
    non-empty bins of `n_bins` uniform bins over [0, 1]."""
    y = _labels(y_true)
    p = np.asarray(y_prob).reshape(-1)
    if p.min() < 0 or p.max() > 1:
        raise ValueError("y_prob has values outside [0, 1].")
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    binids = np.searchsorted(bins[1:-1], p)
    bin_sums = np.bincount(binids, weights=p, minlength=n_bins)
    bin_true = np.bincount(binids, weights=y, minlength=n_bins)
    bin_total = np.bincount(binids, minlength=n_bins)
    nonzero = bin_total != 0
    return bin_true[nonzero] / bin_total[nonzero], bin_sums[nonzero] / bin_total[nonzero]
