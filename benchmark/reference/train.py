"""The training step in plain PyTorch, float32: Dice + BCE on the logits
(tmuird/VAEUNET ``utils/loss.py:6-63``, weights 0.5 and 0.5, smooth 1),
plus beta times the KL divergence with per-dimension free bits
(``loss.py:148-170``: clamped to [-100, 100], floored at the free bits,
summed over the latent, averaged over the batch), the gradient clipped to
a global norm (scaled only when the norm reaches the limit), then AdamW
(betas 0.9 and 0.999, eps 1e-8, decoupled weight decay on every
parameter).  BN runs on batch statistics.

:func:`follow` runs the reference through the steps of a run and returns
what the comparison reads: each step's loss, each leaf's gradient norm in
the first step as the optimizer gets it (after the clip), and each leaf's
change after the last step.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn


def dice_bce(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    x, t = logits.float(), masks.float()
    bce = torch.mean(torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x))))
    p = torch.sigmoid(x).reshape(-1)
    t = t.reshape(-1)
    inter = torch.sum(p * t)
    dice = (2 * inter + 1) / (torch.clamp(p.sum(), min=0.5) + torch.clamp(t.sum(), min=0.5) + 1)
    return 0.5 * bce + 0.5 * (1 - dice)


def kl_free_bits(mu: torch.Tensor, logvar: torch.Tensor, free_bits: float) -> torch.Tensor:
    per_dim = 0.5 * (mu * mu + torch.exp(logvar) - logvar - 1)
    per_dim = torch.clamp(torch.clamp(per_dim, -100, 100), min=free_bits)
    return torch.mean(torch.sum(per_dim, dim=1))


class AdamW:
    """Clip to a global norm, then AdamW, on every parameter of a model."""

    def __init__(self, params: Iterable[Tuple[str, nn.Parameter]], lr: float,
                 weight_decay: float, max_norm: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_norm
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.t = 0

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for _, p in self.params))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        for _, p in self.params:
            p.grad.mul_(scale)
        return norm

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params:
            g = p.grad
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            denom = self.v[n].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def loss_of(model: nn.Module, images: torch.Tensor, masks: torch.Tensor,
            eps: Optional[torch.Tensor], beta: float, free_bits: float) -> torch.Tensor:
    """images NHWC float32 in [0, 1], masks NHWC; eps [B, latent] for the
    VAE-UNet, None for the UNet."""
    x = images.permute(0, 3, 1, 2)
    if eps is None:
        return dice_bce(model(x).permute(0, 2, 3, 1), masks)
    logits, mu, logvar = model(x, eps)
    return dice_bce(logits.permute(0, 2, 3, 1), masks) + beta * kl_free_bits(mu, logvar,
                                                                            free_bits)


def follow(model: nn.Module, batches, beta: float, free_bits: float, lr: float,
           weight_decay: float, max_norm: float, half_batch: bool = False) -> Dict:
    """Train `model` (float32, on its device) through `batches`, an
    iterable of (images, masks, eps or None).  ``half_batch`` is a planted
    fault: each step leaves out the second half of its rows.
    -> {"loss": [per step], "grad": {leaf: norm in step 1}, "change": {leaf: norm}}"""
    model.train()
    named = [(n, p) for n, p in model.named_parameters()]
    start = {n: p.detach().clone() for n, p in named}
    opt = AdamW(named, lr, weight_decay, max_norm)
    losses, grads = [], {}
    for images, masks, eps in batches:
        if half_batch:
            b = images.shape[0] // 2
            images, masks = images[:b], masks[:b]
            eps = None if eps is None else eps[:b]
        for _, p in named:
            p.grad = None
        loss = loss_of(model, images, masks, eps, beta, free_bits)
        loss.backward()
        opt.clip()
        if not grads:
            grads = {n: p.grad.norm() for n, p in named}
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        change = {n: (p - start[n]).norm() for n, p in named}
    return {"loss": [float(v) for v in losses],
            "grad": {n: float(v) for n, v in grads.items()},
            "change": {n: float(v) for n, v in change.items()}}
