"""Thresholded evaluation metrics.  Port of ``vaeunet_tpu/metrics.py``
(reference ``utils/metrics.py``).

The reference quirk stays: validation calls ``get_all_metrics`` on raw
logits, so the > 0.5 threshold is sigmoid > 0.622; ``apply_sigmoid=True``
is the fixed behaviour.  ``valid`` is a [B] 0/1 row mask that drops
loader-padded rows, so a padded batch scores as the true-size batch.  The
metrics return fp32 scalar tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _binarize(pred: torch.Tensor, target: torch.Tensor, apply_sigmoid: bool = False,
              valid: Optional[torch.Tensor] = None):
    """-> flat (pred01, target01, weight01)."""
    pred = pred.float()
    if apply_sigmoid:
        pred = torch.sigmoid(pred)
    p = (pred > 0.5).float()
    t = (target.float() > 0.5).float()
    if valid is None:
        return p.reshape(-1), t.reshape(-1), torch.ones(p.numel(), device=p.device)
    per = p.numel() // p.shape[0]
    w = torch.repeat_interleave(torch.as_tensor(valid, device=p.device).float(), per)
    return p.reshape(-1) * w, t.reshape(-1) * w, w


def dice_score(pred, target, epsilon: float = 1e-6, apply_sigmoid: bool = False, valid=None):
    """Hard Dice at 0.5; 1.0 when both sides are empty (metrics.py:32-33)."""
    p, t, _ = _binarize(pred, target, apply_sigmoid, valid)
    intersection = torch.sum(p * t)
    denominator = torch.sum(p) + torch.sum(t)
    dice = (2.0 * intersection + epsilon) / (denominator + epsilon)
    return torch.where(denominator == 0, torch.ones_like(dice), dice)


def multiclass_dice_score(pred, target, epsilon: float = 1e-6, apply_sigmoid: bool = False):
    """Dice with the class axis (axis 1) flattened into the batch
    (metrics.py:38-41)."""
    return dice_score(pred.reshape(-1, *pred.shape[2:]), target.reshape(-1, *target.shape[2:]),
                      epsilon, apply_sigmoid)


def dice_loss_metric(pred, target, multiclass: bool = False):
    """1 - hard Dice (metrics.py:44-47; the trainable soft Dice is in
    ``losses.py``)."""
    fn = multiclass_dice_score if multiclass else dice_score
    return 1.0 - fn(pred, target)


def iou_score(pred, target, epsilon: float = 1e-6, apply_sigmoid: bool = False, valid=None):
    p, t, _ = _binarize(pred, target, apply_sigmoid, valid)
    intersection = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t) - intersection
    return (intersection + epsilon) / (union + epsilon)


def precision_recall(pred, target, epsilon: float = 1e-6, apply_sigmoid: bool = False,
                     valid=None):
    p, t, _ = _binarize(pred, target, apply_sigmoid, valid)
    tp = torch.sum(p * t)
    fp = torch.sum(p) - tp
    fn = torch.sum(t) - tp
    return (tp + epsilon) / (tp + fp + epsilon), (tp + epsilon) / (tp + fn + epsilon)


def specificity(pred, target, epsilon: float = 1e-6, apply_sigmoid: bool = False, valid=None):
    p, t, w = _binarize(pred, target, apply_sigmoid, valid)
    tn = torch.sum(w) - torch.sum(p) - torch.sum(t) + torch.sum(p * t)
    fp = torch.sum(p) - torch.sum(p * t)
    return (tn + epsilon) / (tn + fp + epsilon)


def accuracy(pred, target, apply_sigmoid: bool = False, valid=None):
    p, t, w = _binarize(pred, target, apply_sigmoid, valid)
    return torch.sum(w * (p == t).float()) / torch.sum(w)


def get_all_metrics(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 1e-6,
                    apply_sigmoid: bool = False, valid=None) -> Dict[str, torch.Tensor]:
    """dice / iou / precision / recall / specificity / accuracy at 0.5.
    (metrics.py:98-117)"""
    prec, rec = precision_recall(pred, target, epsilon, apply_sigmoid, valid)
    return {
        "dice": dice_score(pred, target, epsilon, apply_sigmoid, valid),
        "iou": iou_score(pred, target, epsilon, apply_sigmoid, valid),
        "precision": prec,
        "recall": rec,
        "specificity": specificity(pred, target, epsilon, apply_sigmoid, valid),
        "accuracy": accuracy(pred, target, apply_sigmoid, valid),
    }


class MetricTracker:
    """Best-dice bookkeeping across train / val phases.  (metrics.py:120-147)"""

    STANDARD = ("loss", "dice", "iou", "precision", "recall", "specificity", "accuracy")

    def __init__(self):
        self.metrics = {phase: {m: [] for m in self.STANDARD} for phase in ("train", "val")}
        self.best_dice = 0.0

    def update(self, phase: str, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.metrics[phase].setdefault(k, []).append(float(v))

    def get_current(self, phase: str) -> Dict[str, float]:
        return {k: (v[-1] if v else 0.0) for k, v in self.metrics[phase].items()}

    def is_best_dice(self, current_dice: float) -> bool:
        if current_dice > self.best_dice:
            self.best_dice = float(current_dice)
            return True
        return False
