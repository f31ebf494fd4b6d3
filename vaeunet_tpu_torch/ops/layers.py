"""Layer primitives with the reference's PyTorch semantics.  Port of
``vaeunet_tpu/ops/layers.py``.

The JAX package had to rebuild ``nn.Conv2d``'s init and ``nn.BatchNorm2d``'s
running-variance rule by hand; here they are the torch modules themselves.
The convolutions run on cuDNN through ``F.conv2d`` (the JAX package left
them to XLA), in the input's type as the JAX ``Conv`` computes them
(``layers.py:72,93-109``).  What the port adds:

- :func:`bn_relu` sends every eval-mode BatchNorm -> ReLU pair through the
  fused kernel of ``ops/pallas/bn_relu.py``;
- :func:`conv3x3_bn` sends every stride-1, pad-1, bias-free 3x3 conv that
  feeds a training-mode BatchNorm through ``ops/pallas/conv_bn_stats.py``,
  whose moments :meth:`BatchNorm.forward_moments` normalizes with (the JAX
  ``BatchNorm(moments=...)``, ``layers.py:252-284``).  The JAX package
  gates that kernel behind ``VAEUNET_FUSED_CONV_BN`` (``ops/fused.py``);
  the port always takes it, so it has no switch.

The fused-decoder helpers ``SlicedConv`` / ``constant_input_term`` are
exact rewrites of the concatenation form, which the port computes
directly (``models/vae_unet.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vaeunet_tpu_torch.ops.pallas.bn_relu import fused_bn_relu
from vaeunet_tpu_torch.ops.pallas.conv_bn_stats import conv3x3_bn_stats


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with PyTorch-default init (kaiming-uniform(a=sqrt(5))
    weights, uniform(+-1/sqrt(fan_in)) bias), the init the JAX ``Conv``
    reproduces.  The fp32 weight and bias are cast to the input's type, so
    a bf16 activation runs a bf16 convolution (a no-op in fp32)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def takes_bn_stats_kernel(self) -> bool:
        """3x3, stride 1, pad 1, no bias, no groups or dilation: the shape
        ``conv3x3_bn_stats`` computes."""
        return (self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1 and self.bias is None)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5): biased batch variance to
    normalize, unbiased to update the running variance."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward_moments(self, y: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Training-mode BN of `y` from its per-channel fp32 sum `s` and sum
        of squares `q` (the JAX ``BatchNorm(moments=(s, q))``): mean = s/n,
        var = max(q/n - mean^2, 0) with n = numel / C; running statistics
        move by momentum with the unbiased var * n / (n - 1); the math is
        fp32 and the output takes y's type.  Differentiable in y, s, q and
        the affine parameters."""
        c = y.shape[1]
        n = y.numel() // c
        mean = s / n
        var = torch.clamp(q / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c, 1, 1)
        out = (y.float() - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return out.to(y.dtype)


def bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """ReLU(bn(x)).  In eval mode: the fused kernel (plain version on the
    CPU).  In training mode: batch-statistics BN, then ReLU."""
    if bn.training:
        return F.relu(bn(x))
    return fused_bn_relu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def conv3x3_bn(conv: Conv, bn: BatchNorm, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """bn(conv(x)), then ReLU if `relu`.  A training-mode BN after a conv
    of the kernel's shape takes the fused conv + moments kernel; anything
    else (eval mode, a strided conv) keeps ``F.conv2d`` and, for a BN ->
    ReLU pair in eval mode, the ``bn_relu`` kernel, as before."""
    if bn.training and conv.takes_bn_stats_kernel():
        y, s, q = conv3x3_bn_stats(x, conv.weight.to(x.dtype))
        y = bn.forward_moments(y, s, q)
        return F.relu(y) if relu else y
    if relu:
        return bn_relu(conv(x), bn)
    return bn(conv(x))
