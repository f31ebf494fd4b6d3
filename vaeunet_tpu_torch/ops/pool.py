"""Pooling ops on NCHW tensors.  Port of ``vaeunet_tpu/ops/pool.py``.

``nn.MaxPool2d`` semantics (the ResNet stem's 3/2/1 pool pads with -inf)
and ``AdaptiveAvgPool2d(1)`` + squeeze.  The JAX package computed these
outside any Pallas kernel, so they stay plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Max pool over H, W."""
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Global average pool: [B, C, H, W] -> [B, C]."""
    return x.mean(dim=(2, 3))
