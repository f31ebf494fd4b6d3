"""Layer primitives with the reference's PyTorch semantics.  Port of
``vaeunet_tpu/ops/layers.py``.

The JAX package had to rebuild ``nn.Conv2d``'s init and ``nn.BatchNorm2d``'s
running-variance rule by hand; here they are the torch modules themselves.
The convolutions run on cuDNN through ``F.conv2d`` (the JAX package left
them to XLA).  What the port adds is :func:`bn_relu`, which sends every
eval-mode BatchNorm -> ReLU pair through the fused kernel of
``ops/pallas/bn_relu.py``.

The fused-decoder helpers ``SlicedConv`` / ``constant_input_term`` are
exact rewrites of the concatenation form, which the port computes
directly (``models/vae_unet.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vaeunet_tpu_torch.ops.pallas.bn_relu import fused_bn_relu


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with PyTorch-default init (kaiming-uniform(a=sqrt(5))
    weights, uniform(+-1/sqrt(fan_in)) bias), the init the JAX ``Conv``
    reproduces."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5): biased batch variance to
    normalize, unbiased to update the running variance."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)


def bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """ReLU(bn(x)).  In eval mode: the fused kernel (plain version on the
    CPU).  In training mode: batch-statistics BN, then ReLU."""
    if bn.training:
        return F.relu(bn(x))
    return fused_bn_relu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
