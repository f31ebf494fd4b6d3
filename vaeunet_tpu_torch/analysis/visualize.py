"""Uncertainty visualization suite.  Port of
``vaeunet_tpu/analysis/visualize.py``.

Rebuild of reference ``visualize_vae.py``'s figure generators:
- plot_reconstruction             <- visualize_vae.py:655-737 (3x3 panel)
- visualize_temperature_sampling  <- :740-866 (per-T mean/std rows)
- generate_and_compare_ensemble   <- :869-1080 (weighted multi-T ensemble,
                                    weights 1/(|T-1|+0.5), Dice bars)
- downsample_for_display          <- :1166-1210

All figure content matches the JAX package's.  One ``torch.Generator``
draws the latents of every call in turn (the JAX package splits a key per
temperature).  The JAX package's jitted ``lax.map`` over the latents
(``_mean_prediction_at_temperature``) is a loop over decodes here, or
``predict_tiled_ensemble`` when tiled.  Every function runs on CUDA
unless called with ``device="cpu"``.  Figures come from
``utils/figures.py`` (matplotlib where it is installed, else its PIL
renderer: the card's machine has no matplotlib).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vaeunet_tpu_torch.device import as_image, check_serving_model, resolve_device
from vaeunet_tpu_torch.inference.predict import segmentation_distribution, uncertainty_maps
from vaeunet_tpu_torch.inference.tiled import predict_tiled_ensemble
from vaeunet_tpu_torch.models.vae_unet import UNetResNet, resolve_injection
from vaeunet_tpu_torch.utils.figures import gridspec as figures_gridspec
from vaeunet_tpu_torch.utils.figures import pyplot
from vaeunet_tpu_torch.vae_utils import sample_latents, to_nchw, to_nhwc

log = logging.getLogger(__name__)


def downsample_for_display(arr: np.ndarray, max_size: int = 512) -> np.ndarray:
    """Area-ish downscale of an [H,W] or [H,W,C] array for plotting."""
    h, w = arr.shape[0], arr.shape[1]
    if max(h, w) <= max_size:
        return arr
    scale = max_size / max(h, w)
    nh, nw = int(h * scale), int(w * scale)
    ii = np.clip((np.arange(nh) / scale).astype(int), 0, h - 1)
    jj = np.clip((np.arange(nw) / scale).astype(int), 0, w - 1)
    return arr[ii][:, jj]


def plot_reconstruction(model: UNetResNet, dataset, img_id: str,
                        generator: Optional[torch.Generator], num_samples: int = 32,
                        patch_size: Optional[int] = None,
                        temperature: float = 1.0, batch_size: int = 4,
                        overlap: Optional[int] = None, device=None):
    """3x3 uncertainty panel: input / GT / mean; std / entropy / MI; 3 samples.
    (visualize_vae.py:655-737)"""
    plt = pyplot()

    img, mask = dataset.get_image_and_mask(img_id)
    samples, _, _ = segmentation_distribution(
        model, img, generator, num_samples=num_samples, temperature=temperature,
        patch_size=patch_size, tile_batch=batch_size, overlap=overlap, device=device)
    metrics = {k: v.cpu().numpy() for k, v in uncertainty_maps(samples).items()}
    samples = samples.cpu().numpy()

    fig = plt.figure(figsize=(20, 16))
    gs = figures_gridspec().GridSpec(3, 3, figure=fig)
    gs.update(wspace=0.3, hspace=0.3)

    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(downsample_for_display(np.clip(img, 0, 1)))
    ax.set_title("Input Image", fontsize=12, pad=10)
    ax.axis("off")

    ax = fig.add_subplot(gs[0, 1])
    ax.imshow(downsample_for_display(mask[..., 0]), cmap="gray")
    ax.set_title("Ground Truth", fontsize=12, pad=10)
    ax.axis("off")

    ax = fig.add_subplot(gs[0, 2])
    ax.imshow(downsample_for_display(metrics["mean"][..., 0]), cmap="gray")
    ax.set_title(f"Mean Prediction\n(T={temperature}, N={num_samples})",
                 fontsize=12, pad=10)
    ax.axis("off")

    panels = [("std", "Std Deviation\n(Aleatory Uncertainty)"),
              ("entropy", "Entropy\n(Epistemic Uncertainty)"),
              ("mutual_info", "Mutual Information\n(Total Uncertainty)")]
    for i, (key, title) in enumerate(panels):
        ax = fig.add_subplot(gs[1, i])
        im = ax.imshow(downsample_for_display(metrics[key][..., 0]), cmap="hot")
        ax.set_title(title, fontsize=12, pad=10)
        ax.axis("off")
        plt.colorbar(im, ax=ax)

    for i in range(min(3, samples.shape[0])):
        ax = fig.add_subplot(gs[2, i])
        ax.imshow(downsample_for_display(samples[i, ..., 0]), cmap="gray")
        ax.set_title(f"Sample {i + 1}", fontsize=12, pad=10)
        ax.axis("off")

    fig.suptitle("VAE-UNet Segmentation Analysis", fontsize=14, y=0.95)
    return fig


@torch.inference_mode()
def _encode(model: UNetResNet, image: torch.Tensor):
    """(mu, logvar) [1, D] of the whole [H,W,C] image (visualize.py:109-111):
    the encoder sees the whole image even when the decodes are tiled."""
    return model.encode(to_nchw(image[None]))


@torch.inference_mode()
def _mean_prediction_at_temperature(model: UNetResNet, image: torch.Tensor, mu, logvar,
                                    generator: Optional[torch.Generator],
                                    temperature: float, samples_per_temp: int,
                                    should_sample: bool, patch_size: Optional[int],
                                    batch_size: int, overlap: Optional[int] = None
                                    ) -> torch.Tensor:
    """Mean sigmoid map [H,W,1] over samples_per_temp draws at one
    temperature (visualize.py:114-137)."""
    h, w = image.shape[0], image.shape[1]
    t = temperature if should_sample else 0.0
    zs = sample_latents(mu, logvar, generator, t, samples_per_temp)[:, 0]
    if patch_size is not None and (h > patch_size or w > patch_size):
        preds = predict_tiled_ensemble(model, image, zs, patch_size, overlap=overlap,
                                       batch_size=batch_size, device=image.device)
    else:
        _, _, features = model.encode_with_features(to_nchw(image[None]))
        preds = torch.stack([
            to_nhwc(torch.sigmoid(
                model.decode_features(z[None], features, output_hw=(h, w)).float()))[0]
            for z in zs])
    return preds.mean(dim=0)


def _hard_dice(pred: np.ndarray, mask: np.ndarray) -> float:
    p = pred > 0.5
    g = mask > 0.5
    return float(2.0 * (p & g).sum() / (p.sum() + g.sum() + 1e-8))


def visualize_temperature_sampling(model, image, mask, generator: Optional[torch.Generator],
                                   temperatures: Sequence[float] = (0.5, 1.0, 2.0, 3.0),
                                   samples_per_temp: int = 5,
                                   patch_size: Optional[int] = None,
                                   batch_size: int = 4,
                                   overlap: Optional[int] = None, device=None):
    """Grid: per-temperature mean and std rows.  (visualize_vae.py:740-866)"""
    plt = pyplot()

    image_np = np.asarray(image)
    _, _, should_sample = resolve_injection(model.latent_injection)

    n = len(temperatures)
    fig, axes = plt.subplots(2, n + 1, figsize=(4 * (n + 1), 8))
    axes[0, 0].imshow(downsample_for_display(np.clip(image_np, 0, 1)))
    axes[0, 0].set_title("Original Image")
    axes[1, 0].imshow(downsample_for_display(np.asarray(mask)[..., 0]), cmap="gray")
    axes[1, 0].set_title("Ground Truth")
    for a in (axes[0, 0], axes[1, 0]):
        a.axis("off")

    for i, t in enumerate(temperatures):
        tt = t if should_sample else 0.0
        preds, _, _ = segmentation_distribution(
            model, image, generator, num_samples=samples_per_temp, temperature=tt,
            patch_size=patch_size, tile_batch=batch_size, overlap=overlap, device=device)
        mean = preds.mean(dim=0)[..., 0].cpu().numpy()
        std = preds.std(dim=0, correction=0)[..., 0].cpu().numpy()
        axes[0, i + 1].imshow(downsample_for_display(mean), cmap="gray")
        axes[0, i + 1].set_title(f"Mean (T={t})")
        im = axes[1, i + 1].imshow(downsample_for_display(std), cmap="hot")
        axes[1, i + 1].set_title(f"Std (T={t})")
        plt.colorbar(im, ax=axes[1, i + 1])
        for a in (axes[0, i + 1], axes[1, i + 1]):
            a.axis("off")
    fig.tight_layout()
    return fig


def generate_and_compare_ensemble(model, image, mask, generator: Optional[torch.Generator],
                                  temperatures: Sequence[float] = (0.5, 1.0, 2.0, 3.0),
                                  samples_per_temp: int = 5,
                                  weighted: bool = True,
                                  patch_size: Optional[int] = 512,
                                  batch_size: int = 4,
                                  overlap: Optional[int] = None, device=None):
    """Multi-temperature ensemble with the reference's weighting
    1/(|T-1|+0.5) and Dice bar chart.  (visualize_vae.py:869-1080)
    -> (fig, dict of per-T and ensemble Dice)"""
    plt = pyplot()

    device = resolve_device(device)
    check_serving_model(model, device)
    image_np = np.asarray(image)
    image = as_image(image, device)
    mask_np = np.asarray(mask)[..., 0]
    mu, logvar = _encode(model, image)
    should_sample = model.latent_injection != "none"

    temp_preds: Dict[float, np.ndarray] = {}
    dice_scores: List[float] = []
    for t in temperatures:
        mean_pred = _mean_prediction_at_temperature(
            model, image, mu, logvar, generator, t, samples_per_temp,
            should_sample, patch_size, batch_size, overlap)
        temp_preds[t] = mean_pred[..., 0].cpu().numpy()
        dice_scores.append(_hard_dice(temp_preds[t], mask_np))
        log.info("T=%.2f dice %.4f", t, dice_scores[-1])

    if weighted:
        weights = np.asarray([1.0 / (abs(t - 1.0) + 0.5) for t in temperatures])
    else:
        weights = np.ones(len(temperatures))
    weights = weights / weights.sum()
    ensemble = np.sum([w * temp_preds[t]
                       for w, t in zip(weights, temperatures)], axis=0)
    ensemble_dice = _hard_dice(ensemble, mask_np)
    log.info("Ensemble dice %.4f (weights %s)", ensemble_dice,
             np.round(weights, 4).tolist())

    n = len(temperatures)
    fig = plt.figure(figsize=(15, 10))
    ax = plt.subplot(2, n + 1, 1)
    ax.imshow(downsample_for_display(np.clip(image_np, 0, 1)))
    ax.set_title("Original Image")
    ax.axis("off")
    ax = plt.subplot(2, n + 1, 2)
    ax.imshow(downsample_for_display(mask_np), cmap="gray")
    ax.set_title("Ground Truth")
    ax.axis("off")
    for i, t in enumerate(temperatures):
        ax = plt.subplot(2, n + 1, 3 + i)
        ax.imshow(downsample_for_display(temp_preds[t]), cmap="gray")
        ax.set_title(f"T={t}\nDice={dice_scores[i]:.3f}")
        ax.axis("off")
    ax = plt.subplot(2, n + 1, n + 2)
    ax.imshow(downsample_for_display(ensemble), cmap="gray")
    ax.set_title(f"{'Weighted ' if weighted else ''}Ensemble\n"
                 f"Dice={ensemble_dice:.3f}")
    ax.axis("off")
    ax = plt.subplot(2, n + 1, n + 3)
    labels = [f"T={t}" for t in temperatures] + ["Ensemble"]
    ax.bar(labels, dice_scores + [ensemble_dice],
           color=["steelblue"] * n + ["darkorange"])
    ax.set_ylabel("Dice")
    ax.set_title("Dice by Temperature")
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()

    results = {f"dice_T{t}": d for t, d in zip(temperatures, dice_scores)}
    results["dice_ensemble"] = ensemble_dice
    return fig, results
