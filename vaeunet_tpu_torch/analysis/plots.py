"""Global analysis plots over spilled per-pixel data.  Port of
``vaeunet_tpu/analysis/plots.py``, a copy but for its imports: the sklearn
metrics come from ``utils/sk_metrics.py`` and the figures from
``utils/figures.py`` (matplotlib where it is installed), because the card's
machine has neither sklearn nor matplotlib.

Rebuild of the reference's global aggregation stage
(analyze_model.py:188-470, 473-690, 1071-1158).  All functions read the
per-image ``temp_pixel_data`` spill files written by
vaeunet_tpu_torch.analysis.analyze and write PNGs into `output_dir`,
returning the headline scalars for the tracker/summary.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from vaeunet_tpu_torch.utils.figures import pyplot
from vaeunet_tpu_torch.utils.sk_metrics import (
    auc,
    calibration_curve,
    precision_recall_curve,
    roc_curve,
)

log = logging.getLogger(__name__)


def _load_pairs(processed_ids, temp_dir: Path, suffixes=("pred_flat", "gt_flat"),
                subsample: Optional[int] = None, seed: Optional[int] = None):
    preds, gts = [], []
    rng = np.random.RandomState(seed) if seed is not None else np.random
    for img_id in processed_ids:
        p = temp_dir / f"{img_id}_{suffixes[0]}.npy"
        g = temp_dir / f"{img_id}_{suffixes[1]}.npy"
        if not (p.exists() and g.exists()):
            continue
        pred, gt = np.load(p), np.load(g)
        if subsample and len(pred) > subsample:
            idx = rng.choice(len(pred), subsample, replace=False)
            pred, gt = pred[idx], gt[idx]
        preds.append(pred)
        gts.append(gt)
    if not preds:
        return None, None
    return np.concatenate(preds), np.concatenate(gts)


def _weighted_ece(gt: np.ndarray, pred: np.ndarray, n_bins: int = 10) -> float:
    """Histogram-weighted calibration gap, the reference's global-ECE formula
    (analyze_model.py:231-235)."""
    prob_true, prob_pred = calibration_curve(gt, pred, n_bins=n_bins)
    hist, _ = np.histogram(pred, bins=n_bins, range=(0, 1))
    weights = hist / len(pred)
    # calibration_curve drops empty bins; align by re-binning prob_pred
    bin_ids = np.clip((prob_pred * n_bins).astype(int), 0, n_bins - 1)
    return float(np.sum(np.abs(prob_true - prob_pred) * weights[bin_ids]))


def create_calibration_visualizations(processed_ids, temp_dir, output_dir,
                                      tracker=None) -> Optional[float]:
    """Global calibration curve + weighted ECE.  (analyze_model.py:188-275)"""
    plt = pyplot()

    pred, gt = _load_pairs(processed_ids, Path(temp_dir))
    if pred is None:
        log.warning("No calibration data found")
        return None
    gt = np.round(gt).astype(int)
    try:
        prob_true, prob_pred = calibration_curve(gt, pred, n_bins=10)
    except ValueError as e:
        log.error("calibration_curve failed: %s", e)
        return None
    ece = _weighted_ece(gt, pred)

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.plot(prob_pred, prob_true, marker="o", linewidth=2,
            label=f"Calibration Curve (ECE={ece:.4f})")
    ax.plot([0, 1], [0, 1], "k--", label="Perfect Calibration")
    ax2 = ax.twinx()
    ax2.hist(pred, bins=20, alpha=0.3, density=True, color="gray")
    ax2.set_ylabel("Density")
    ax.set_xlabel("Mean Predicted Probability")
    ax.set_ylabel("Fraction of Positives")
    ax.set_title("Global Calibration Curve (All Images)")
    ax.legend(loc="upper left")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    path = Path(output_dir) / "global_calibration_curve.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    if tracker:
        tracker.summary({"global_ece": ece})
    log.info("Global calibration curve saved to %s (ECE=%.4f)", path, ece)
    return ece


def perform_temperature_analysis(processed_ids, temp_dir, output_dir,
                                 temperatures: Sequence[float],
                                 tracker=None) -> Optional[Dict[str, float]]:
    """Post-hoc temperature scaling: rescale logits by 1/T, pick the T with
    the lowest weighted ECE.  (analyze_model.py:278-387)"""
    plt = pyplot()

    pred, gt = _load_pairs(processed_ids, Path(temp_dir))
    if pred is None:
        return None
    gt = np.round(gt).astype(int)
    eps = 1e-7
    logits = np.log(np.clip(pred, eps, 1 - eps) / (1 - np.clip(pred, eps, 1 - eps)))

    results = []
    for t in temperatures:
        calibrated = 1.0 / (1.0 + np.exp(-logits / t))
        try:
            ece = _weighted_ece(gt, calibrated)
        except ValueError:
            ece = float("nan")
        results.append((t, ece))
    valid = [(t, e) for t, e in results if np.isfinite(e)]
    if not valid:
        log.warning("No finite ECE in temperature analysis")
        return None
    best_t, best_ece = min(valid, key=lambda r: r[1])

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot([t for t, _ in valid], [e for _, e in valid], marker="o")
    ax.scatter([best_t], [best_ece], color="red", s=100, zorder=5,
               label=f"Best T={best_t:.2f} (ECE={best_ece:.4f})")
    ax.set_xlabel("Temperature (T)")
    ax.set_ylabel("Expected Calibration Error (ECE)")
    ax.set_title("ECE vs. Temperature Scaling")
    ax.legend()
    ax.grid(True, alpha=0.3)
    path = Path(output_dir) / "ece_vs_temperature.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    if tracker:
        tracker.summary({"best_temperature": best_t,
                         "best_temperature_ece": best_ece})
    log.info("Best temperature: %.2f (ECE %.4f)", best_t, best_ece)
    return {"best_temperature": best_t, "best_temperature_ece": best_ece}


def plot_global_sparsification_curve(processed_ids, temp_dir, output_dir,
                                     model_label: str = "Model",
                                     tracker=None) -> Optional[float]:
    """Average per-image sparsification curves -> global SE.
    (analyze_model.py:390-470)"""
    plt = pyplot()

    fracs, rands, uncs = [], [], []
    for img_id in processed_ids:
        p = Path(temp_dir) / f"{img_id}_sparsification.npz"
        if p.exists():
            z = np.load(p)
            fracs.append(z["frac_removed"])
            rands.append(z["err_random"])
            uncs.append(z["err_uncertainty"])
    if not fracs:
        return None
    frac = fracs[0]
    err_r = np.mean(rands, axis=0)
    err_u = np.mean(uncs, axis=0)
    se = float(np.trapezoid(err_r - err_u, frac))

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.fill_between(frac, err_r, err_u, alpha=0.2,
                    color="green" if se > 0 else "red")
    ax.plot(frac, err_r, "b--", label="Random")
    ax.plot(frac, err_u, "r-", label=f"{model_label} (by uncertainty)")
    ax.set_xlabel("Fraction of Pixels Removed")
    ax.set_ylabel("Normalized Error")
    ax.set_title(f"Global Sparsification Curve (SE={se:.4f})")
    ax.legend()
    ax.grid(True, alpha=0.3)
    path = Path(output_dir) / "global_sparsification_curve.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    if tracker:
        tracker.summary({"global_sparsification_error": se})
    return se


def plot_global_uncertainty_distribution(processed_ids, temp_dir, output_dir,
                                         model_label: str = "Model",
                                         tracker=None) -> Optional[Dict[str, float]]:
    """Uncertainty boxplots for correct vs incorrect pixels.
    (analyze_model.py:473-576)"""
    plt = pyplot()

    correct, incorrect = [], []
    for img_id in processed_ids:
        p = Path(temp_dir) / f"{img_id}_uncertainty_dist.npz"
        if p.exists():
            z = np.load(p)
            correct.append(z["uncertainties_correct"])
            incorrect.append(z["uncertainties_incorrect"])
    if not correct:
        return None
    uc = np.concatenate(correct)
    ui = np.concatenate(incorrect)
    if len(uc) > 200000:
        uc = np.random.choice(uc, 200000, replace=False)
    if len(ui) > 200000:
        ui = np.random.choice(ui, 200000, replace=False)

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.boxplot([uc, ui], tick_labels=["Correct", "Incorrect"], showfliers=False)
    ax.set_ylabel("Uncertainty (std dev)")
    ax.set_title(f"Uncertainty Distribution by Correctness ({model_label})")
    ax.grid(True, alpha=0.3)
    path = Path(output_dir) / "global_uncertainty_distribution.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    stats = {"mean_uncertainty_correct": float(uc.mean()) if len(uc) else float("nan"),
             "mean_uncertainty_incorrect": float(ui.mean()) if len(ui) else float("nan")}
    if tracker:
        tracker.summary(stats)
    return stats


def plot_global_roc_pr(processed_ids, temp_dir, output_dir,
                       model_label: str = "Model", prefix: str = "global_",
                       tracker=None) -> Optional[Dict[str, float]]:
    """Global error-prediction ROC/PR: uncertainty as a score for
    misclassification.  (analyze_model.py:60-185,1188-1193)"""
    plt = pyplot()

    errs, uncs = [], []
    for img_id in processed_ids:
        e = Path(temp_dir) / f"{img_id}_errors.npy"
        u = Path(temp_dir) / f"{img_id}_uncertainties.npy"
        if e.exists() and u.exists():
            ev = np.load(e)
            uv = np.load(u)
            if len(ev) > 50000:
                idx = np.random.choice(len(ev), 50000, replace=False)
                ev, uv = ev[idx], uv[idx]
            errs.append(ev)
            uncs.append(uv)
    if not errs:
        return None
    errors = np.concatenate(errs)
    unc = np.concatenate(uncs)
    if errors.min() == errors.max():
        log.warning("Degenerate error labels; skipping global ROC/PR")
        return None
    fpr, tpr, _ = roc_curve(errors, unc)
    err_auroc = float(auc(fpr, tpr))
    prec, rec, _ = precision_recall_curve(errors, unc)
    err_auprc = float(auc(rec, prec))

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].plot(fpr, tpr, lw=2, label=f"{model_label} (AUC={err_auroc:.4f})")
    axes[0].plot([0, 1], [0, 1], "k--", label="Chance")
    axes[0].set_xlabel("False Positive Rate")
    axes[0].set_ylabel("True Positive Rate")
    axes[0].set_title("Error-Prediction ROC (uncertainty -> error)")
    axes[0].legend(loc="lower right")
    baseline = errors.mean()
    axes[1].plot(rec, prec, lw=2, label=f"{model_label} (AUC={err_auprc:.4f})")
    axes[1].axhline(baseline, color="k", linestyle="--",
                    label=f"Chance={baseline:.3f}")
    axes[1].set_xlabel("Recall")
    axes[1].set_ylabel("Precision")
    axes[1].set_title("Error-Prediction PR")
    axes[1].legend(loc="upper right")
    for a in axes:
        a.grid(alpha=0.3)
    fig.tight_layout()
    path = Path(output_dir) / f"{prefix}error_roc_pr.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    if tracker:
        tracker.summary({f"{prefix}error_auroc": err_auroc,
                         f"{prefix}error_auprc": err_auprc})
    return {"error_auroc": err_auroc, "error_auprc": err_auprc}


def create_uncertainty_visualizations(metrics_df, output_dir, tracker=None):
    """2x2 per-image metric summary: dice-vs-ECE and dice-vs-SE scatters,
    ECE and UE-Dice histograms.  (analyze_model.py:579-690)"""
    plt = pyplot()

    if metrics_df is None or not len(metrics_df):
        return None
    fig, axes = plt.subplots(2, 2, figsize=(14, 12))
    axes = axes.flatten()
    axes[0].scatter(metrics_df["dice"], metrics_df["ece"], s=80, alpha=0.7)
    axes[0].set_title("Segmentation Accuracy vs. Calibration Error")
    axes[0].set_xlabel("Dice Score (higher is better)")
    axes[0].set_ylabel("ECE (lower is better)")
    axes[1].scatter(metrics_df["dice"], metrics_df["sparsification_error"],
                    s=80, alpha=0.7, color="darkorange")
    axes[1].set_title("Segmentation Accuracy vs. Uncertainty Quality")
    axes[1].set_xlabel("Dice Score (higher is better)")
    axes[1].set_ylabel("Sparsification Error")
    axes[2].hist(metrics_df["ece"].dropna(), bins=10, color="teal", alpha=0.8)
    axes[2].set_title("Distribution of Expected Calibration Error")
    axes[2].set_xlabel("ECE (lower is better)")
    axes[3].hist(metrics_df["uncertainty_error_dice"].dropna(), bins=10,
                 color="indigo", alpha=0.8)
    axes[3].set_title("Distribution of Uncertainty-Error Dice")
    axes[3].set_xlabel("U-E Dice (higher indicates better overlap)")
    for a in axes:
        a.grid(alpha=0.3)
    fig.tight_layout()
    path = Path(output_dir) / "uncertainty_summary.png"
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return str(path)


def plot_segmentation_roc_pr(processed_ids, temp_dir, output_dir,
                             model_label: str = "Model",
                             tracker=None) -> Optional[Dict[str, float]]:
    """Global segmentation ROC/PR (50k-px/image subsample).
    (analyze_model.py:1071-1158)"""
    plt = pyplot()

    pred, gt = _load_pairs(processed_ids, Path(temp_dir), subsample=50000)
    if pred is None:
        return None
    gt = gt.astype(int)
    if gt.min() == gt.max():
        return None
    fpr, tpr, _ = roc_curve(gt, pred)
    seg_auroc = float(auc(fpr, tpr))
    prec, rec, _ = precision_recall_curve(gt, pred)
    seg_auprc = float(auc(rec, prec))

    for name, (xs, ys, xl, yl, chance) in {
        "global_segmentation_roc_curve.png": (
            fpr, tpr, "False Positive Rate", "True Positive Rate", ([0, 1], [0, 1])),
        "global_segmentation_pr_curve.png": (
            rec, prec, "Recall", "Precision",
            ([0, 1], [gt.mean(), gt.mean()])),
    }.items():
        fig, ax = plt.subplots(figsize=(6, 6))
        label_auc = seg_auroc if "roc" in name else seg_auprc
        ax.plot(xs, ys, lw=2, label=f"{model_label} (AUC={label_auc:.4f})")
        ax.plot(*chance, "k--", label="Chance")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_title(name.replace("_", " ").replace(".png", ""))
        ax.legend()
        ax.grid(alpha=0.3)
        fig.savefig(Path(output_dir) / name, dpi=300, bbox_inches="tight")
        plt.close(fig)
    if tracker:
        tracker.summary({"segmentation/auroc": seg_auroc,
                         "segmentation/auprc": seg_auprc})
    return {"seg_auroc": seg_auroc, "seg_auprc": seg_auprc}
