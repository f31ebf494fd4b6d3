"""Segmentation losses and the KL machinery.  Port of
``vaeunet_tpu/losses.py`` (reference ``utils/loss.py``).

Every function reduces to an fp32 scalar whatever the input type, so it
drops into a bf16 train step.  Masks and logits are taken as the JAX
package takes them, channel last; only ``multichannel_combined_loss``
depends on that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def _nan_to_num01(x: torch.Tensor) -> torch.Tensor:
    """nan->0, +inf->1, -inf->0 (reference loss.py:14,79)."""
    return torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice loss on sigmoid probabilities.  (loss.py:6-28)"""
    probs = _nan_to_num01(torch.sigmoid(logits.float())).reshape(-1)
    targets = targets.float().reshape(-1)
    intersection = torch.sum(probs * targets)
    probs_sum = torch.clamp(torch.sum(probs), min=smooth / 2.0)
    targets_sum = torch.clamp(torch.sum(targets), min=smooth / 2.0)
    dice = (2.0 * intersection + smooth) / (probs_sum + targets_sum + smooth)
    return 1.0 - dice


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, the stable form
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    logits = logits.float()
    targets = targets.float()
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(loss)


def combined_loss(logits: torch.Tensor, targets: torch.Tensor, bce_weight: float = 0.5,
                  dice_weight: float = 0.5) -> torch.Tensor:
    """BCE + Dice combination.  (loss.py:44-63)"""
    return (bce_weight * bce_with_logits(logits, targets)
            + dice_weight * dice_loss(logits, targets))


def ma_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.8,
                  gamma: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """Focal loss tuned for microaneurysms.  (loss.py:66-92)"""
    probs = _nan_to_num01(torch.sigmoid(logits.float()))
    targets = targets.float()
    p_t = targets * probs + (1 - targets) * (1 - probs)
    focal_weight = torch.pow(1 - p_t, gamma)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    bce = -targets * torch.log(probs + eps) - (1 - targets) * torch.log(1 - probs + eps)
    return torch.mean(_nan_to_num01(alpha_t * focal_weight * bce))


def ma_segmentation_loss(logits: torch.Tensor, targets: torch.Tensor, dice_weight: float = 0.5,
                         focal_weight: float = 0.5, focal_gamma: float = 2.0,
                         class_weight: float = 0.9) -> torch.Tensor:
    """Dice + focal combination for MA lesions.  (loss.py:95-111)"""
    return (dice_weight * dice_loss(logits, targets)
            + focal_weight * ma_focal_loss(logits, targets, alpha=class_weight,
                                           gamma=focal_gamma))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.8,
               gamma: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """Secondary focal-loss variant.  (utils/metrics.py:150-172)"""
    probs = torch.sigmoid(logits.float()).reshape(-1)
    targets = targets.float().reshape(-1)
    bce = -targets * torch.log(probs + eps) - (1 - targets) * torch.log(1 - probs + eps)
    pt = torch.where(targets == 1, probs, 1 - probs)
    alpha_weight = torch.where(targets == 1, torch.full_like(probs, alpha),
                               torch.full_like(probs, 1 - alpha))
    return torch.mean(alpha_weight * torch.pow(1 - pt, gamma) * bce)


def kl_with_free_bits(mu: torch.Tensor, logvar: torch.Tensor, free_bits: float = 1e-4,
                      clamp_leak: float = 0.0) -> torch.Tensor:
    """KL(q(z|x) || N(0, 1)) with per-dimension free bits.  (loss.py:148-170)

    Per-dimension KL 0.5 (mu^2 + e^logvar - logvar - 1), clamped to
    [-100, 100], floored at `free_bits`, summed over dimensions, averaged
    over the batch.  `clamp_leak` > 0 keeps the clamped value but lets a
    `clamp_leak`-scaled gradient of the excess through (the JAX
    ``excess - stop_gradient(excess)`` straight-through term).
    """
    mu = torch.nan_to_num(mu.float(), nan=0.0)
    logvar = torch.nan_to_num(logvar.float(), nan=0.0)
    kl_per_dim = 0.5 * (mu * mu + torch.exp(logvar) - logvar - 1.0)
    clipped = torch.clamp(kl_per_dim, -100.0, 100.0)
    if clamp_leak > 0:
        excess = kl_per_dim - clipped
        clipped = clipped + clamp_leak * (excess - excess.detach())
    kl_per_dim = clipped
    if free_bits > 0:
        kl_per_dim = torch.clamp(kl_per_dim, min=free_bits)
    kl = torch.mean(torch.sum(kl_per_dim, dim=1))
    return torch.nan_to_num(kl, nan=1e-8)


@dataclass
class KLAnnealer:
    """Anneals the KL weight (beta) over warm-up epochs.  (loss.py:114-145)
    Host-side: call ``get_weight(epoch)`` and pass the float to the step."""

    kl_start: float = 0.0
    kl_end: float = 1.0
    warmup_epochs: int = 10
    strategy: str = "linear"  # 'linear' | 'cyclical' | 'constant'

    def get_weight(self, epoch: float, batch: Optional[int] = None,
                   num_batches: Optional[int] = None) -> float:
        if self.strategy == "constant":
            return self.kl_end
        if batch is not None and num_batches is not None:
            progress = (epoch + batch / num_batches) / self.warmup_epochs
        else:
            progress = epoch / self.warmup_epochs
        progress = min(progress, 1.0)
        if self.strategy == "linear":
            return self.kl_start + progress * (self.kl_end - self.kl_start)
        if self.strategy == "cyclical":
            cycle = progress % 1.0
            return self.kl_start + cycle * (self.kl_end - self.kl_start)
        return self.kl_end


def multichannel_combined_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over the last (channel) axis of the BCE + Dice combination:
    the multi-task 'ALL' loss."""
    n = logits.shape[-1]
    per = [combined_loss(logits[..., i], targets[..., i]) for i in range(n)]
    return torch.mean(torch.stack(per))


def make_criterion(lesion_type: str, override: str = "auto"):
    """Loss selection (train.py:312-316): MA gets focal + Dice, 'ALL' the
    per-channel combination, everything else BCE + Dice; `override`
    'combined' / 'focal' forces one for any lesion type."""
    if override == "combined":
        return combined_loss
    if override == "focal" or (override == "auto" and lesion_type == "MA"):
        return lambda logits, targets: ma_segmentation_loss(logits, targets, class_weight=0.9)
    if lesion_type == "ALL":
        return multichannel_combined_loss
    return combined_loss
