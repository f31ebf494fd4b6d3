"""Per-image uncertainty analysis pipeline.  Port of
``vaeunet_tpu/analysis/analyze.py``.

Rebuild of reference ``analyze_model.py:694-1228`` (analyze_model): for each
unique test image, draw N tempered latent samples, predict (tiled or full),
compute per-image uncertainty metrics, spill per-pixel arrays, then run the
global aggregation stage (calibration, temperature scaling, sparsification,
uncertainty distributions, ROC/PR) and write ``analysis_metrics.csv`` with
the reference's 7-column schema (img_id, dice, ece, sparsification_error,
uncertainty_error_dice, error_auroc, error_auprc).  ``extended_metrics``
adds the older analyzer's superset columns (brier, nll, mean_entropy,
mean_mutual_info, mean_coeff_variation, uncertain_pixel_percent).

Differences from the JAX package (values unchanged):
- one ``torch.Generator`` on the device, seeded once from ``args.seed``,
  draws every image's latents (the JAX package splits a key per image);
- the sample stack comes to the host once; the extended metrics' maps are
  computed from the device tensor (``inference.predict.uncertainty_maps``);
- an image's device work (its request, and the attention forward) runs
  outside the per-image ``try``: a failed launch or a CUDA error fails the
  run instead of dropping the image's CSV row.  The skip still covers the
  image's host work: loading, metrics and spills;
- attention maps come from ``models.vae_unet.capture_attention`` (one
  deterministic z = mu forward), not flax ``sow``.
"""

from __future__ import annotations

import logging
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from vaeunet_tpu_torch.analysis import plots as gplots
from vaeunet_tpu_torch.device import resolve_device
from vaeunet_tpu_torch.inference.ensemble import expected_area_threshold
from vaeunet_tpu_torch.inference.predict import segmentation_distribution, uncertainty_maps
from vaeunet_tpu_torch.models.vae_unet import UNetResNet, capture_attention, resolve_injection
from vaeunet_tpu_torch.uncertainty import (
    brier_score,
    calculate_expected_calibration_error,
    calculate_negative_log_likelihood,
    calculate_segmentation_metrics_chunked,
    calculate_sparsification_metrics,
    calculate_uncertainty_error_auc,
    calculate_uncertainty_error_dice,
)
from vaeunet_tpu_torch.utils.figures import colormap
from vaeunet_tpu_torch.utils.tensor_utils import ensure_dict_python_scalars
from vaeunet_tpu_torch.vae_utils import to_nchw

log = logging.getLogger(__name__)

_SPILLS = ("_pred_flat.npy", "_gt_flat.npy", "_errors.npy", "_uncertainties.npy",
           "_sparsification.npz", "_uncertainty_dist.npz")


@dataclass
class AnalyzeArgs:
    """Mirrors the reference CLI (analyze_model.py:1230-1269)."""
    lesion_type: str = "EX"
    temperature: float = 1.0
    samples: int = 10
    patch_size: Optional[int] = None
    overlap: Optional[int] = 100
    output_dir: str = "./analysis_results"
    max_images: Optional[int] = None
    temp_values: Sequence[float] = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
    model_label: str = "VAE-UNet"
    batch_size: int = 4
    extended_metrics: bool = False
    keep_temp_data: bool = False
    seed: int = 0
    # Decision rule (framework extension; the reference always uses a
    # global 0.5, analyze_model.py:884-886).  "area" picks a per-image
    # threshold from the map's soft mass (inference.expected_area_threshold).
    threshold_mode: str = "fixed"
    area_factor: float = 1.0
    # The global plot/aggregation stage is host-CPU-heavy and identical
    # across configs of the same model, so a grid of runs can skip it.
    global_plots: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def analyze_model(model: UNetResNet, dataset, args: AnalyzeArgs, tracker=None, device=None,
                  report: Optional[Dict[str, Any]] = None):
    """-> pandas DataFrame of per-image metrics (+ CSV and plots on disk).

    `device`: CUDA unless ``"cpu"``.  `report`, a dict the caller passes,
    receives ``images`` (per analyzed image: ``img_id``, ``hw``,
    ``request_s``, the device request ending in a synchronize; ``fetch_s``, the sample stack's
    copy to the host; ``host_s``, metrics and spills) and ``global_s``
    (the aggregation stage)."""
    import pandas as pd

    device = resolve_device(device)
    report = {} if report is None else report
    report["images"] = []
    out_dir = Path(args.output_dir) / (
        f"{args.lesion_type}_T{args.temperature}_N{args.samples}")
    out_dir.mkdir(parents=True, exist_ok=True)
    temp_dir = out_dir / "temp_pixel_data"
    temp_dir.mkdir(parents=True, exist_ok=True)

    _, _, should_sample = resolve_injection(model.latent_injection)
    if not should_sample:
        log.info("Latent injection '%s': deterministic mu (temperature ignored)",
                 model.latent_injection)

    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    metrics_data: List[dict] = []
    processed_ids: List[str] = []

    for img_id in dataset.unique_image_ids():
        if args.max_images and len(processed_ids) >= args.max_images:
            break
        log.info("Processing image %s", img_id)
        try:
            img, mask = dataset.get_image_and_mask(img_id)
        except Exception as e:
            log.error("Error loading image %s: %s", img_id, e, exc_info=True)
            continue

        # --- device work: errors propagate ---
        t0 = time.perf_counter()
        temperature = args.temperature if should_sample else 0.0
        samples, _, _ = segmentation_distribution(
            model, img, generator, num_samples=args.samples, temperature=temperature,
            patch_size=args.patch_size, tile_batch=args.batch_size, overlap=args.overlap,
            device=device)
        extended = None
        if args.extended_metrics:
            maps = uncertainty_maps(samples)
            extended = {k: maps[k].mean() for k in ("entropy", "mutual_info", "cv")}
            del maps
        _sync(device)
        t1 = time.perf_counter()
        samples_np = samples[..., 0].cpu().numpy()               # [N,H,W]
        if extended is not None:
            extended = {k: float(v) for k, v in extended.items()}
        del samples
        t2 = time.perf_counter()
        attention = _attention_maps(model, img, args, device) if tracker is not None else None

        # --- host work: a failure skips the image ---
        t3 = time.perf_counter()
        gt = np.asarray(mask)[..., 0]
        try:
            row, mean_pred, std_dev = _image_metrics(img_id, samples_np, gt, args, temp_dir,
                                                     extended)
            metrics_data.append(ensure_dict_python_scalars(row))
            processed_ids.append(img_id)
        except Exception as e:
            log.error("Error processing image %s: %s", img_id, e, exc_info=True)
            for suffix in _SPILLS:
                (temp_dir / f"{img_id}{suffix}").unlink(missing_ok=True)
            continue
        report["images"].append({"img_id": str(img_id), "hw": tuple(img.shape[:2]),
                                 "request_s": t1 - t0,
                                 "fetch_s": t2 - t1, "host_s": time.perf_counter() - t3})
        if tracker is not None:
            _log_image_panel(tracker, img_id, img, gt, mean_pred, std_dev)
            _log_attention_maps(tracker, attention, img_id)

    metrics_df = pd.DataFrame(metrics_data)
    for col in metrics_df.columns:
        if col != "img_id":
            metrics_df[col] = pd.to_numeric(metrics_df[col], errors="coerce")
    csv_path = out_dir / "analysis_metrics.csv"
    metrics_df.to_csv(csv_path, index=False)
    log.info("Saved metrics data to %s", csv_path)

    t0 = time.perf_counter()
    if args.global_plots:
        _global_stage(metrics_df, processed_ids, temp_dir, out_dir, args, tracker)
    elif len(metrics_df):
        log.info("Analyzed %d images | Dice %.4f | errAUROC %.4f "
                 "(global plot stage skipped)", len(metrics_df),
                 metrics_df["dice"].mean(), metrics_df["error_auroc"].mean())
    if not args.keep_temp_data:
        shutil.rmtree(temp_dir, ignore_errors=True)
    report["global_s"] = time.perf_counter() - t0
    return metrics_df


def _image_metrics(img_id, samples_np: np.ndarray, gt: np.ndarray, args: AnalyzeArgs,
                   temp_dir: Path, extended: Optional[Dict[str, float]]):
    """-> (CSV row, mean map, std map) of one image from its [N,H,W]
    samples and [H,W] mask, with its per-pixel spills
    (analyze_model.py:884-953)."""
    mean_pred = samples_np.mean(axis=0)
    std_dev = samples_np.std(axis=0)
    if args.threshold_mode == "area":
        thr = expected_area_threshold(mean_pred, args.area_factor)
        log.info("%s: expected-area threshold %.3f", img_id, thr)
    else:
        thr = 0.5
    pred_binary = (mean_pred > thr).astype(np.float32)

    gt_round = np.round(gt).astype(int)
    ue_dice = calculate_uncertainty_error_dice(std_dev, pred_binary, gt)
    ece, *_ = calculate_expected_calibration_error(mean_pred, gt)
    dice = float((2.0 * (pred_binary * gt).sum())
                 / (pred_binary.sum() + gt.sum() + 1e-8))

    np.save(temp_dir / f"{img_id}_pred_flat.npy", mean_pred.reshape(-1).astype(np.float32))
    np.save(temp_dir / f"{img_id}_gt_flat.npy", gt_round.reshape(-1))

    frac, err_r, err_u = calculate_sparsification_metrics(
        mean_pred[None], std_dev[None], gt[None], num_points=20)
    if err_r[0] > 0:
        norm_r, norm_u = err_r / err_r[0], err_u / err_r[0]
    else:
        norm_r, norm_u = err_r, err_u
    se = float(np.trapezoid(norm_r - norm_u, frac))
    np.savez(temp_dir / f"{img_id}_sparsification.npz",
             frac_removed=frac, err_random=err_r, err_uncertainty=err_u)

    correct = pred_binary == gt
    np.savez(temp_dir / f"{img_id}_uncertainty_dist.npz",
             uncertainties_correct=std_dev[correct],
             uncertainties_incorrect=std_dev[~correct])
    errors = (pred_binary != gt).astype(np.int32).reshape(-1)
    np.save(temp_dir / f"{img_id}_errors.npy", errors)
    np.save(temp_dir / f"{img_id}_uncertainties.npy", std_dev.reshape(-1).astype(np.float32))

    auroc, auprc = calculate_uncertainty_error_auc(mean_pred, gt, std_dev)
    row = {
        "img_id": str(img_id),
        "dice": dice,
        "ece": ece,
        "sparsification_error": se,
        "uncertainty_error_dice": ue_dice,
        "error_auroc": auroc,
        "error_auprc": auprc,
    }
    if extended is not None:
        row.update({
            "brier": brier_score(mean_pred, gt),
            "nll": calculate_negative_log_likelihood(mean_pred, gt),
            "mean_entropy": extended["entropy"],
            "mean_mutual_info": extended["mutual_info"],
            "mean_coeff_variation": extended["cv"],
            "uncertain_pixel_percent": float((std_dev > 0.2).mean() * 100),
        })
    return row, mean_pred, std_dev


def _global_stage(metrics_df, processed_ids, temp_dir: Path, out_dir: Path,
                  args: AnalyzeArgs, tracker) -> None:
    """The global aggregation stage (analyze_model.py:1069-1208)."""
    gplots.plot_segmentation_roc_pr(processed_ids, temp_dir, out_dir,
                                    model_label=args.model_label, tracker=tracker)
    seg_metrics = calculate_segmentation_metrics_chunked(
        processed_ids, temp_dir, threshold=0.5, chunk_size=100000)
    log.info("[Segmentation Metrics - Global] %s",
             {k: round(v, 4) for k, v in seg_metrics.items()})
    gplots.create_calibration_visualizations(processed_ids, temp_dir, out_dir,
                                             tracker=tracker)
    gplots.perform_temperature_analysis(processed_ids, temp_dir, out_dir,
                                        args.temp_values, tracker=tracker)
    gplots.plot_global_sparsification_curve(processed_ids, temp_dir, out_dir,
                                            model_label=args.model_label, tracker=tracker)
    gplots.plot_global_uncertainty_distribution(processed_ids, temp_dir, out_dir,
                                                model_label=args.model_label,
                                                tracker=tracker)
    gplots.plot_global_roc_pr(processed_ids, temp_dir, out_dir,
                              model_label=args.model_label, tracker=tracker)
    gplots.create_uncertainty_visualizations(metrics_df, out_dir, tracker=tracker)

    if tracker is not None and len(metrics_df):
        tracker.summary({
            "summary/avg_dice": float(metrics_df["dice"].mean()),
            "summary/avg_ece": float(metrics_df["ece"].mean()),
            "summary/avg_sparsification_error":
                float(metrics_df["sparsification_error"].mean()),
            "summary/avg_uncertainty_error_dice":
                float(metrics_df["uncertainty_error_dice"].mean()),
            "summary/avg_error_auroc": float(metrics_df["error_auroc"].mean()),
            "summary/avg_error_auprc": float(metrics_df["error_auprc"].mean()),
            **{f"segmentation/{k}": v for k, v in seg_metrics.items()},
        })

    if len(metrics_df):
        log.info("Analyzed %d images | Dice %.4f+-%.4f | ECE %.4f+-%.4f | "
                 "SE %.4f | UE-Dice %.4f | errAUROC %.4f | errAUPRC %.4f",
                 len(metrics_df), metrics_df["dice"].mean(),
                 metrics_df["dice"].std(), metrics_df["ece"].mean(),
                 metrics_df["ece"].std(),
                 metrics_df["sparsification_error"].mean(),
                 metrics_df["uncertainty_error_dice"].mean(),
                 metrics_df["error_auroc"].mean(),
                 metrics_df["error_auprc"].mean())


def _log_image_panel(tracker, img_id, img, gt, mean_pred, std_dev):
    """Original / GT / mean-pred / colored-uncertainty images.
    (analyze_model.py:961-1010)"""
    try:
        img_vis = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        gt_vis = (gt * 255).clip(0, 255).astype(np.uint8)
        pr = (mean_pred - mean_pred.min()) / (mean_pred.max() - mean_pred.min() + 1e-8)
        pred_vis = (pr * 255).astype(np.uint8)
        un = (std_dev - std_dev.min()) / (std_dev.max() - std_dev.min() + 1e-8)
        unc_vis = (colormap("hot")(un)[:, :, :3] * 255).astype(np.uint8)
        tracker.log_image(f"visualizations/{img_id}/original_image", img_vis)
        tracker.log_image(f"visualizations/{img_id}/ground_truth", gt_vis)
        tracker.log_image(f"visualizations/{img_id}/mean_prediction", pred_vis)
        tracker.log_image(f"visualizations/{img_id}/uncertainty_map_std_dev", unc_vis)
    except Exception as e:
        log.warning("Could not log visualizations for %s: %s", img_id, e)


@torch.inference_mode()
def _attention_maps(model: UNetResNet, img, args: AnalyzeArgs,
                    device: torch.device) -> Optional[Dict[str, np.ndarray]]:
    """Attention-gate psi maps [H_i, W_i] of one deterministic z = mu
    forward, on the host; full-image mode only, like the reference's hook
    path (analyze_model.py:713-715,801-880).  Device work: errors
    propagate."""
    if args.patch_size is not None or not any(b.use_attention for b in model.decoder_blocks):
        return None
    x = to_nchw(torch.as_tensor(img, dtype=torch.float32, device=device)[None])
    with capture_attention(model) as maps:
        model(x, sample=False)
    return {k: v[0, 0].float().cpu().numpy() for k, v in maps.items()}


def _log_attention_maps(tracker, attention, img_id) -> None:
    """The maps of :func:`_attention_maps` as viridis images."""
    if not attention:
        return
    try:
        for name, amap in attention.items():
            amap = (amap - amap.min()) / (amap.max() - amap.min() + 1e-8)
            vis = (colormap("viridis")(amap)[:, :, :3] * 255).astype(np.uint8)
            tracker.log_image(f"attention/{img_id}/{name.replace('.', '_')}_psi", vis)
    except Exception as e:
        log.warning("Could not log attention maps for %s: %s", img_id, e)
