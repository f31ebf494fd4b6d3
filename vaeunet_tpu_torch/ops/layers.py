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
directly (``models/vae_unet.py``).  :class:`ConvTranspose2x`, the plain
UNet's learned upsample, runs on cuDNN (``F.conv_transpose2d``): the JAX
package has no Pallas kernel for it.

Under data parallelism with global-batch BN (``parallel/dp.py``, the
counterpart of the JAX package's pjit step, whose BN sees the global
logical batch, ``parallel/dp.py:4-9``), a training-mode :class:`BatchNorm`
whose ``group`` is set sums its per-channel fp32 moments over the group's
ranks (``ops/collectives.py``, differentiable, so their cotangents are
summed too) and normalizes with the counts of the whole group: the conv
kernel's (s, q) at the :func:`conv3x3_bn` sites, fp32 Σx and Σx² at the
plain sites (the strided convs, the 1x1 downsamples, the latent and gate
BNs).  ``group`` is None outside such a step.

Inside the recompute of a rematerialized block (``ops/remat.py``) a
training-mode :class:`BatchNorm` normalizes as it did in the forward but
leaves its running statistics alone, so that they move once a step; under
``'save_convs'`` :func:`conv3x3_bn` hands back the conv products the
forward kept instead of computing them again.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vaeunet_tpu_torch.ops import remat
import torch.distributed as dist

from vaeunet_tpu_torch.ops.collectives import all_reduce_sum
from vaeunet_tpu_torch.ops.pallas.bn_relu import fused_bn_relu
from vaeunet_tpu_torch.ops.pallas.conv_bn_stats import conv3x3_bn_stats, fold_cotangents


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

    # tensor parallelism's two hooks around the conv itself, identities
    # here: a column-parallel conv of ``parallel/tp.py`` marks its input for
    # the backward's sum over the model group and gathers its slice of
    # output channels.  :func:`conv3x3_bn` calls them outside the products
    # remat 'save_convs' keeps, so that the kept products are the slice's.
    def tp_input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_output(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return t

    def local_conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """This rank's conv of `x` at `weight`, without bias or hooks."""
        return nn.Conv2d._conv_forward(self, x, weight, None)

    def takes_bn_stats_kernel(self) -> bool:
        """3x3, stride 1, pad 1, no bias, no groups or dilation: the shape
        ``conv3x3_bn_stats`` computes."""
        return (self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1 and self.bias is None)


class ConvTranspose2x(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(in, out, kernel_size=2, stride=2)`` (reference
    unet/unet_parts.py:76; JAX ``ops/layers.py:112``), computed in the
    input's type as :class:`Conv` is."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5): biased batch variance to
    normalize, unbiased to update the running variance."""

    # the data-parallel group whose ranks' batches a training-mode forward
    # normalizes together (set for the duration of a global-batch step)
    group = None

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group is not None:
            x32 = x.float()
            return self.forward_moments(x, x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)))
        if self.training and remat.bn_frozen():
            # the same call on copies of the running statistics: the same
            # output, and the update lands in the copies.  Not None instead:
            # batch_norm would then save two tensors fewer for the backward
            # than in the forward, and the checkpoint matches them by count
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        return super().forward(x)

    def forward_moments(self, y: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Training-mode BN of `y` from its per-channel fp32 sum `s` and sum
        of squares `q` (the JAX ``BatchNorm(moments=(s, q))``): mean = s/n,
        var = max(q/n - mean^2, 0) with n = numel / C; running statistics
        move by momentum with the unbiased var * n / (n - 1); the math is
        fp32 and the output takes y's type.  Differentiable in y, s, q and
        the affine parameters.  With ``group`` set, s and q are summed over
        its ranks first and n counts all their rows."""
        c = y.shape[1]
        n = y.numel() // c
        if self.group is not None:
            s, q = all_reduce_sum(torch.stack([s, q]), self.group).unbind()
            n *= dist.get_world_size(self.group)
        mean = s / n
        var = torch.clamp(q / n - mean * mean, min=0.0)
        if not remat.bn_frozen():
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


class _KeptConv(torch.autograd.Function):
    """The recompute's stand-in for a bias-free conv under remat
    ``'save_convs'``: returns the products the forward kept (y, or the
    kernel's y, s, q) with the conv's backward.  It saves what the conv it
    stands for saved (x and the weight, and the kernel's y), so that the
    checkpoint matches the recompute's saved tensors to the forward's."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, kept):
        ctx.set_materialize_grads(False)
        ctx.conv = (list(stride), list(padding))
        y = kept[:1] if len(kept) == 3 else ()      # the kernel also saves its y
        ctx.save_for_backward(x, weight, *y)
        return kept

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        x, weight, *y = ctx.saved_tensors
        if all(g is None for g in grads):
            return None, None, None, None, None
        if y:       # the kernel's (y, s, q): fold the moments' cotangents
            g = fold_cotangents(y[0], *grads, x.dtype)
        else:
            g = grads[0].contiguous(memory_format=torch.channels_last)
        stride, padding = ctx.conv
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, weight, None, stride, padding, [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


def _kept(conv: Conv, x: torch.Tensor, weight: torch.Tensor, compute):
    """``compute()``, kept for the recompute under remat ``'save_convs'``."""
    return remat.kept(compute, lambda kept: _KeptConv.apply(x, weight, conv.stride,
                                                            conv.padding, kept))


def conv3x3_bn(conv: Conv, bn: BatchNorm, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """bn(conv(x)) of a bias-free 3x3 conv, then ReLU if `relu`.  A
    training-mode BN after a conv of the kernel's shape takes the fused
    conv + moments kernel; anything else (eval mode, a strided conv) keeps
    ``F.conv2d`` and, for a BN -> ReLU pair in eval mode, the ``bn_relu``
    kernel, as before.  In training the conv's products are the ones remat
    ``'save_convs'`` keeps."""
    if conv.bias is not None:
        raise ValueError("conv3x3_bn takes a bias-free conv")
    if not bn.training:
        y = conv(x)
        return bn_relu(y, bn) if relu else bn(y)
    w = conv.weight.to(x.dtype)
    x = conv.tp_input(x)
    if conv.takes_bn_stats_kernel():
        y, s, q = _kept(conv, x, w, lambda: conv3x3_bn_stats(x, w))
        y = bn.forward_moments(conv.tp_output(y), conv.tp_output(s, 0), conv.tp_output(q, 0))
    else:
        (y,) = _kept(conv, x, w, lambda: (conv.local_conv(x, w),))
        y = bn(conv.tp_output(y))
    return F.relu(y) if relu else y
