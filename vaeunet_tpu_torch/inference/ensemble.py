"""Multi-model (cross-scale) probability fusion.  Port of
``vaeunet_tpu/inference/ensemble.py``.

The two regimes of lesion size are covered by models trained at different
scales; this module fuses their per-image mean probability maps at native
resolution.  Each member is itself an N-sample tempered latent ensemble
(``segmentation_distribution``), so fusion composes with the uncertainty
machinery.

- fused_probability         <- ensemble.py:32-72; one ``torch.Generator``
  serves the members in turn (the JAX package splits a key per member);
  a member mean of another size is resized by ``ops/resize.py``
  (align_corners=False), the row kernel at one channel
- expected_area_threshold   <- ensemble.py:78-103, host numpy
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.inference.predict import segmentation_distribution
from vaeunet_tpu_torch.ops.resize import resize_bilinear

_FUSIONS = ("max", "mean")


@torch.inference_mode()
def fused_probability(members: Sequence[Tuple[torch.nn.Module, object]],
                      generator: Optional[torch.Generator] = None,
                      *,
                      num_samples: int = 10,
                      temperature: float = 1.0,
                      patch_size: Optional[int] = None,
                      tile_batch: int = 8,
                      out_hw: Optional[Tuple[int, int]] = None,
                      fusion: str = "max",
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse mean probability maps from several (model, image) members into
    one [H, W, 1] map.

    Each member's ``image`` ([h, w, C]) may be at a different scale; its
    mean probability map is bilinearly resized (align_corners=False, the
    data pipeline's convention, utils/data_loading.py:518-529) to
    ``out_hw`` (default: the first member's image size) before fusion.

    Returns ``(fused [H,W,1], member_means [M,H,W,1])`` on `device` (CUDA
    unless ``"cpu"``).
    """
    if fusion not in _FUSIONS:
        raise ValueError(f"fusion must be one of {_FUSIONS}, got {fusion!r}")
    if not members:
        raise ValueError("need at least one ensemble member")
    if out_hw is None:
        out_hw = tuple(members[0][1].shape[:2])

    means = []
    for model, image in members:
        samples, _, _ = segmentation_distribution(
            model, image, generator, num_samples=num_samples, temperature=temperature,
            patch_size=patch_size, tile_batch=tile_batch, device=device)
        mean = samples.mean(dim=0)                              # [h, w, 1]
        if tuple(mean.shape[:2]) != tuple(out_hw):
            mean = resize_bilinear(mean.permute(2, 0, 1)[None], tuple(out_hw),
                                   align_corners=False)[0].permute(1, 2, 0)
        means.append(mean)

    stack = torch.stack(means)                                  # [M, H, W, 1]
    fused = stack.amax(dim=0) if fusion == "max" else stack.mean(dim=0)
    return fused, stack


def expected_area_threshold(prob, area_factor: float = 1.0) -> float:
    """Per-image decision threshold from the map's own soft mass.

    Picks the threshold t such that the predicted area ``|{p > t}|`` is the
    largest count not exceeding ``area_factor * sum(p)``: the
    calibration-consistent estimate of lesion area.  A framework extension
    (the reference thresholds every map at a global 0.5,
    analyze_model.py:884-886): on an under-confident image the soft mass is
    dominated by the low-probability halo, so the threshold lands just
    above the halo and keeps the confident cores.  Host-side numpy; a
    torch tensor on any device is moved to the host first.
    """
    if isinstance(prob, torch.Tensor):
        prob = prob.detach().cpu().numpy()
    flat = np.asarray(prob, dtype=np.float32).reshape(-1)
    target = float(area_factor) * float(flat.sum())
    n = min(int(target), flat.size)
    if n <= 0:
        return 1.0
    # threshold at the n-th largest probability: |{p > t}| <= n by
    # construction (ties at t are excluded)
    return float(np.partition(flat, flat.size - n)[flat.size - n])
