"""Uncertainty-quantification metrics.  Port of ``vaeunet_tpu/uncertainty.py``
(reference ``utils/uncertainty_metrics.py``), a copy but for its imports.

Host-side numpy: these run offline over spilled per-pixel arrays, not on
the device.  Semantics match the reference exactly, including its seeding
of the random-sparsification baseline and the monotonic enforcement pass.
Inputs are numpy arrays (a torch tensor is moved to the host first).
Differences from the JAX package: the sklearn metrics come from
``utils/sk_metrics.py`` (numpy versions held against sklearn), and the
figures from ``utils/figures.py`` (matplotlib where it is installed),
because the card's machine has neither sklearn nor matplotlib.

- calculate_segmentation_metrics_chunked <- uncertainty_metrics.py:10-106
- calculate_expected_calibration_error   <- :108-135
- brier_score                            <- :137-139
- plot_reliability_diagram               <- :141-173
- calculate_sparsification_metrics       <- :175-240
- plot_sparsification_curve              <- :242-269
- calculate_uncertainty_error_auc        <- :270-283
- calculate_segmentation_metrics         <- :287-332
- calculate_negative_log_likelihood      <- :334-338
- calculate_uncertainty_error_dice       <- :340-353
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vaeunet_tpu_torch.utils.figures import pyplot
from vaeunet_tpu_torch.utils.sk_metrics import (
    auc,
    average_precision_score,
    precision_recall_curve,
    roc_auc_score,
    roc_curve,
)

log = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):          # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def calculate_segmentation_metrics_chunked(processed_ids: Sequence[str],
                                           temp_pixel_data_dir,
                                           threshold: float = 0.5,
                                           chunk_size: int = 100000,
                                           subsample: int = 10000) -> Dict[str, float]:
    """Global confusion-matrix metrics + AUROC/AUPRC from per-image spilled
    ``<id>_pred_flat.npy`` / ``<id>_gt_flat.npy`` files, with a
    `subsample`-pixel/image cap for the rank metrics."""
    temp_pixel_data_dir = Path(temp_pixel_data_dir)
    total_tp = total_fp = total_tn = total_fn = 0
    total_elements = 0
    all_scores: List[np.ndarray] = []
    all_labels: List[np.ndarray] = []

    for img_id in processed_ids:
        try:
            pred_path = temp_pixel_data_dir / f"{img_id}_pred_flat.npy"
            gt_path = temp_pixel_data_dir / f"{img_id}_gt_flat.npy"
            if not (pred_path.exists() and gt_path.exists()):
                continue
            pred = np.load(pred_path)
            gt = np.load(gt_path)
            if len(pred) > subsample:
                idx = np.random.choice(len(pred), subsample, replace=False)
                all_scores.append(pred[idx])
                all_labels.append(gt[idx])
            else:
                all_scores.append(pred)
                all_labels.append(gt)
            for i in range(0, len(pred), chunk_size):
                pc = pred[i:i + chunk_size]
                gc_ = gt[i:i + chunk_size]
                pb = (pc > threshold).astype(np.int32)
                gb = gc_.astype(np.int32)
                total_tp += int(np.sum((pb == 1) & (gb == 1)))
                total_fp += int(np.sum((pb == 1) & (gb == 0)))
                total_tn += int(np.sum((pb == 0) & (gb == 0)))
                total_fn += int(np.sum((pb == 0) & (gb == 1)))
                total_elements += len(pc)
        except Exception as e:
            log.warning("Error processing file for %s: %s", img_id, e)

    precision = total_tp / (total_tp + total_fp) if (total_tp + total_fp) > 0 else 0.0
    recall = total_tp / (total_tp + total_fn) if (total_tp + total_fn) > 0 else 0.0
    specificity = total_tn / (total_tn + total_fp) if (total_tn + total_fp) > 0 else 0.0
    accuracy = ((total_tp + total_tn) / total_elements) if total_elements else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    try:
        scores = np.concatenate(all_scores)
        labels = np.concatenate(all_labels)
        fpr, tpr, _ = roc_curve(labels, scores)
        roc_auc = auc(fpr, tpr)
        pc, rc, _ = precision_recall_curve(labels, scores)
        pr_auc = auc(rc, pc)
    except Exception as e:
        log.error("Error calculating ROC/PR metrics: %s", e)
        roc_auc = pr_auc = float("nan")
    return {"seg_auroc": roc_auc, "seg_auprc": pr_auc, "precision": precision,
            "recall": recall, "specificity": specificity,
            "accuracy": accuracy, "f1_score": f1}


def calculate_expected_calibration_error(pred_probs, ground_truth,
                                         num_bins: int = 10):
    """-> (ece, bin_accs, bin_confs, bin_counts); 10 uniform bins,
    [lower, upper) membership.  (uncertainty_metrics.py:108-135)"""
    p = _np(pred_probs).reshape(-1).astype(np.float64)
    g = _np(ground_truth).reshape(-1).astype(np.float64)
    bounds = np.linspace(0, 1, num_bins + 1)
    accs = np.zeros(num_bins)
    confs = np.zeros(num_bins)
    counts = np.zeros(num_bins)
    for b in range(num_bins):
        in_bin = (p >= bounds[b]) & (p < bounds[b + 1])
        counts[b] = in_bin.sum()
        if counts[b] > 0:
            accs[b] = g[in_bin].mean()
            confs[b] = p[in_bin].mean()
    total = counts.sum()
    ece = float((counts * np.abs(accs - confs)).sum() / total) if total else 0.0
    return ece, accs.astype(np.float32), confs.astype(np.float32), counts


def brier_score(pred_probs, ground_truth) -> float:
    p = _np(pred_probs).astype(np.float32)
    g = _np(ground_truth).astype(np.float32)
    return float(np.mean(np.square(p - g)))


def calculate_sparsification_metrics(pred_probs, uncertainties, ground_truth,
                                     num_points: int = 20):
    """Remove pixels by uncertainty rank vs at random, tracking normalized
    mean BCE pixel error; monotonic-enforced.  Keeps the reference's per-point
    seeding (np.random.seed(i + b*1000)) for reproducibility.
    (uncertainty_metrics.py:175-240)"""
    p = _np(pred_probs).astype(np.float64)
    u = _np(uncertainties).astype(np.float64)
    g = _np(ground_truth).astype(np.float64)
    if p.ndim == 1:
        p, u, g = p[None], u[None], g[None]
    batch_size = p.shape[0]
    eps = 1e-7
    # The reference's probabilities come straight from sigmoid and are always
    # in [0,1]; a resized or blended map may overshoot by ~1 ulp, which would
    # turn log(1-p+eps) NaN and silently zero the whole image's
    # sparsification curve below.  Clipping is an identity for in-range
    # inputs, so reference parity is unaffected.
    p = np.clip(p, 0.0, 1.0)
    pixel_errors = -(g * np.log(p + eps) + (1 - g) * np.log(1 - p + eps))
    pe = pixel_errors.reshape(batch_size, -1)
    uf = u.reshape(batch_size, -1)

    fraction_removed = np.linspace(0, 0.99, num_points)
    errors_random = np.zeros(num_points)
    errors_uncertainty = np.zeros(num_points)

    for b in range(batch_size):
        be, bu = pe[b], uf[b]
        if np.all(be == be[0]) or np.isnan(be).any():
            continue
        initial = be.mean()
        if initial <= 0 or np.isnan(initial):
            continue
        n = be.shape[0]
        all_idx = np.arange(n)
        order = np.argsort(bu)[::-1]  # most uncertain first
        for i, frac in enumerate(fraction_removed):
            remove = int(n * frac)
            keep = n - remove
            if keep <= 0:
                errors_random[i] += 1.0
                errors_uncertainty[i] += 1.0
                continue
            np.random.seed(i + b * 1000)
            rand_idx = np.random.choice(all_idx, keep, replace=False)
            errors_random[i] += be[rand_idx].mean() / initial
            errors_uncertainty[i] += be[order[remove:]].mean() / initial

    errors_random /= batch_size
    errors_uncertainty /= batch_size
    if errors_random[0] > 0:
        errors_random = errors_random / errors_random[0]
    if errors_uncertainty[0] > 0:
        errors_uncertainty = errors_uncertainty / errors_uncertainty[0]
    for i in range(1, num_points):
        if errors_uncertainty[i] > errors_uncertainty[i - 1]:
            errors_uncertainty[i] = errors_uncertainty[i - 1]
    errors_random = np.nan_to_num(errors_random, nan=1.0, posinf=1.0, neginf=0.0)
    errors_uncertainty = np.nan_to_num(errors_uncertainty, nan=1.0,
                                       posinf=1.0, neginf=0.0)
    return fraction_removed, errors_random, errors_uncertainty


def sparsification_error(fraction_removed, errors_random, errors_uncertainty) -> float:
    """SE = integral(random - by-uncertainty)  (uncertainty_metrics.py:246)."""
    return float(np.trapezoid(errors_random - errors_uncertainty, fraction_removed))


def calculate_uncertainty_error_auc(mean_pred, gt_mask, uncertainty_map):
    """AUROC/AUPRC of uncertainty predicting misclassification.
    (uncertainty_metrics.py:270-283)"""
    pred_binary = (_np(mean_pred).reshape(-1) > 0.5).astype(np.float32)
    gt = _np(gt_mask).reshape(-1)
    unc = _np(uncertainty_map).reshape(-1)
    errors = (pred_binary != gt).astype(np.int32)
    try:
        return (float(roc_auc_score(errors, unc)),
                float(average_precision_score(errors, unc)))
    except ValueError:
        return float("nan"), float("nan")


def calculate_segmentation_metrics(predictions, ground_truth,
                                   threshold: float = 0.5) -> Dict[str, float]:
    """Full-array segmentation AUROC/AUPRC + thresholded precision/recall/
    specificity.  (uncertainty_metrics.py:287-332)"""
    p = _np(predictions).reshape(-1)
    g = _np(ground_truth).reshape(-1)
    try:
        seg_auroc = float(roc_auc_score(g, p))
        seg_auprc = float(average_precision_score(g, p))
        pb = (p > threshold).astype(np.int32)
        tp = int(np.sum((pb == 1) & (g == 1)))
        fp = int(np.sum((pb == 1) & (g == 0)))
        tn = int(np.sum((pb == 0) & (g == 0)))
        fn = int(np.sum((pb == 0) & (g == 1)))
        return {
            "seg_auroc": seg_auroc, "seg_auprc": seg_auprc,
            "precision": tp / (tp + fp) if (tp + fp) else 0.0,
            "recall": tp / (tp + fn) if (tp + fn) else 0.0,
            "specificity": tn / (tn + fp) if (tn + fp) else 0.0,
        }
    except Exception as e:
        log.error("Error calculating segmentation metrics: %s", e)
        return {k: float("nan") for k in
                ("seg_auroc", "seg_auprc", "precision", "recall", "specificity")}


def calculate_negative_log_likelihood(predictions, targets,
                                      epsilon: float = 1e-9) -> float:
    p = np.clip(_np(predictions).astype(np.float64), epsilon, 1 - epsilon)
    t = _np(targets).astype(np.float64)
    return float(np.mean(-(t * np.log(p) + (1 - t) * np.log(1 - p))))


def calculate_uncertainty_error_dice(uncertainty_map, predictions_binary,
                                     targets,
                                     uncertainty_threshold: float = 0.2) -> float:
    """Dice between high-uncertainty regions and error regions.
    (uncertainty_metrics.py:340-353)"""
    hu = (_np(uncertainty_map) > uncertainty_threshold).astype(np.float32)
    err = (_np(predictions_binary) != _np(targets)).astype(np.float32)
    intersection = float((hu * err).sum())
    denominator = float(hu.sum() + err.sum())
    if denominator == 0:
        return 1.0 if intersection == 0 else 0.0
    return float(2.0 * intersection / (denominator + 1e-8))


# ----------------------------------------------------------------- plots

def plot_reliability_diagram(bin_accs, bin_confs, bin_counts, ax=None):
    """(uncertainty_metrics.py:141-173)"""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(8, 8))
    counts = np.asarray(bin_counts, np.float64)
    normalized = counts / counts.max() if counts.max() > 0 else counts
    centers = np.linspace(0.05, 0.95, len(bin_accs))
    width = 0.35
    ax.bar(centers - width / 2, bin_accs, width, alpha=0.7, color="blue",
           label="Accuracy")
    ax.bar(centers + width / 2, bin_confs, width, alpha=0.7, color="green",
           label="Confidence")
    gap = np.abs(np.asarray(bin_accs) - np.asarray(bin_confs))
    for c, a, f, g in zip(centers, bin_accs, bin_confs, gap):
        if g > 0.05:
            ax.plot([c, c], [min(a, f), max(a, f)], color="red", lw=2, alpha=0.7)
    ax2 = ax.twinx()
    ax2.bar(centers, normalized, width=width * 1.8, alpha=0.15, color="gray")
    ax2.set_ylabel("Relative Frequency", color="gray")
    ax2.set_ylim(0, 1.1)
    ax.plot([0, 1], [0, 1], "k--", label="Perfect Calibration")
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.set_title("Reliability Diagram")
    ax.legend(loc="upper left")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    return ax


def plot_sparsification_curve(fraction_removed, errors_random,
                              errors_uncertainty, ax=None):
    """-> (ax, SE)  (uncertainty_metrics.py:242-269)"""
    if ax is None:
        _, ax = pyplot().subplots(figsize=(8, 6))
    se = sparsification_error(fraction_removed, errors_random, errors_uncertainty)
    color = "green" if se > 0 else "red"
    ax.fill_between(fraction_removed, errors_random, errors_uncertainty,
                    alpha=0.2, color=color)
    ax.plot(fraction_removed, errors_random, "b--", label="Random")
    ax.plot(fraction_removed, errors_uncertainty, "r-", label="By Uncertainty")
    ax.axhline(y=0.5, color="gray", linestyle=":", alpha=0.6)
    ax.set_xlabel("Fraction of Pixels Removed")
    ax.set_ylabel("Normalized Error")
    ax.set_title(f"Sparsification Curve (SE={se:.4f})")
    ax.legend(loc="best")
    ax.grid(True, alpha=0.3)
    ax.set_xlim(0, max(fraction_removed))
    ax.set_ylim(0, 1.1)
    return ax, se
