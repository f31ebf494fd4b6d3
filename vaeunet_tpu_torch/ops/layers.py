"""Layer primitives with the reference's PyTorch semantics.  Port of
``vaeunet_tpu/ops/layers.py``.

The JAX package had to rebuild ``nn.Conv2d``'s init and ``nn.BatchNorm2d``'s
running-variance rule by hand; here they are the torch modules themselves.
The convolutions run on cuDNN through ``F.conv2d`` (the JAX package left
them to XLA), in the input's type as the JAX ``Conv`` computes them
(``layers.py:72,93-109``).  What the port adds:

- :func:`bn_relu` sends every eval-mode BatchNorm -> ReLU pair through the
  fused kernel of ``ops/pallas/bn_relu.py``;
- :meth:`BatchNorm.forward` sends every training-mode BN of a CUDA tensor
  whose ``group`` is None through ``ops/pallas/bn_train.py::bn_batch``
  (a moments pass, then the ``bn_train`` math on the ``bn_batch_`` kernels),
  with the ReLU of a BN -> ReLU pair inside it (``relu=True``, as
  :func:`bn_relu` and the strided branch of :func:`conv3x3_bn` call it) and
  the SiLU of a BN -> SiLU pair (``silu=True``, the EfficientNet encoder's);
- :class:`DepthwiseConv` is a depthwise conv on cuDNN's grouped
  ``F.conv2d`` in channels_last memory, and :class:`SqueezeExcite` the
  squeeze-excite gate on torch's ops, its mean pool accumulated in fp32
  (``models/efficientnet.py``; the JAX package has neither);
- :func:`conv3x3_bn` sends every stride-1, pad-1, bias-free 3x3 conv that
  feeds a training-mode BatchNorm through ``ops/pallas/conv_bn_stats.py``,
  whose moments the BN normalizes with (the JAX ``BatchNorm(moments=...)``,
  ``layers.py:252-284``): :meth:`BatchNorm.forward_fused`, the kernel pair
  of ``ops/pallas/bn_train.py`` (normalize and ReLU forward; a backward
  that folds the moments' cotangents into dy), or, where the moments are
  summed over a group, :meth:`BatchNorm.forward_moments` in torch ops.  The
  JAX package gates the conv kernel behind ``VAEUNET_FUSED_CONV_BN``
  (``ops/fused.py``); the port always takes it, so it has no switch.

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

Every training-mode BN that runs on torch's ops (a CPU tensor's, and
:meth:`BatchNorm.forward_moments`) adds to ``_ext.LAUNCHES``' ``bn_torch``
and ``bn_torch_bytes`` while a profiler session runs; the ``bn_train`` and
``bn_batch`` kernels count themselves.

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

from vaeunet_tpu_torch.ops import _ext, remat
import torch.distributed as dist

from vaeunet_tpu_torch.ops._ext import count_torch_bn
from vaeunet_tpu_torch.ops.collectives import all_reduce_sum
from vaeunet_tpu_torch.ops.pallas.bn_relu import fused_bn_relu
from vaeunet_tpu_torch.ops.pallas.bn_train import (RELU, SILU, Running, activate_plain,
                                                   bn_batch, bn_train, fold_moments,
                                                   move_running, normalize_plain)
from vaeunet_tpu_torch.ops.pallas.conv_bn_stats import conv3x3_bn_stats, fold_cotangents


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with PyTorch-default init (kaiming-uniform(a=sqrt(5))
    weights, uniform(+-1/sqrt(fan_in)) bias), the init the JAX ``Conv``
    reproduces.  The fp32 weight and bias are cast to the input's type, so
    a bf16 activation runs a bf16 convolution (a no-op in fp32)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, groups=groups)

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


class DepthwiseConv(Conv):
    """A bias-free depthwise k x k conv (groups = channels, padding k // 2, as
    timm pads its EfficientNets) on cuDNN's grouped ``F.conv2d``, in
    channels_last memory and x's type.  Counts ``dwconv``, and under a
    profiler the forward's input and output bytes in ``dwconv_bytes``."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1):
        super().__init__(channels, channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=False, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding,
                     self.dilation, self.groups)
        _ext.count_launch("dwconv")
        _ext.count_bytes("dwconv_bytes", x)
        _ext.count_bytes("dwconv_bytes", y)
        return y


class SqueezeExcite(nn.Module):
    """x * sigmoid(conv_expand(silu(conv_reduce(mean over H, W of x)))): the
    squeeze-excite gate of an EfficientNet block (timm's ``SqueezeExcite``),
    its 1x1 convs with bias.  The mean accumulates in fp32 and is rounded to
    x's type for the convs.  Counts ``se``."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv(channels, reduced, 1)
        self.conv_expand = Conv(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean((2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        gate = torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(pooled))))
        _ext.count_launch("se")
        return x * gate


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

    def forward(self, x: torch.Tensor, relu: bool = False, silu: bool = False) -> torch.Tensor:
        """BN of `x`, then ReLU if `relu` or SiLU if `silu`.  Training mode
        on a CUDA tensor: the ``bn_batch`` kernels, the activation inside
        them; with ``group`` set, :meth:`forward_moments` on the group's
        moments; on the CPU torch's training BN.  Eval mode: torch's BN."""
        act = SILU if silu else RELU if relu else 0
        if self.training and self.group is not None:
            x32 = x.float()
            y = self.forward_moments(x, x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)))
        elif self.training and x.is_cuda:
            running = None if remat.bn_frozen() else self._running()
            return bn_batch(x, self.weight, self.bias, act, self.eps, running)
        else:
            if self.training:
                count_torch_bn(x)
            if self.training and remat.bn_frozen():
                # the same call on copies of the running statistics: the same
                # output, and the update lands in the copies.  Not None
                # instead: batch_norm would then save two tensors fewer for
                # the backward than in the forward, and the checkpoint
                # matches them by count
                y = F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                 self.weight, self.bias, True, self.momentum, self.eps)
            else:
                y = super().forward(x)
        return activate_plain(y, act)

    def forward_moments(self, y: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Training-mode BN of `y` from its per-channel fp32 sum `s` and sum
        of squares `q` (the JAX ``BatchNorm(moments=(s, q))``): mean = s/n,
        var = max(q/n - mean^2, 0) with n = numel / C; running statistics
        move by momentum with the unbiased var * n / (n - 1); the math is
        fp32 and the output takes y's type.  Differentiable in y, s, q and
        the affine parameters.  With ``group`` set, s and q are summed over
        its ranks first and n counts all their rows."""
        count_torch_bn(y)
        n = y.numel() // y.shape[1]
        if self.group is not None:
            s, q = all_reduce_sum(torch.stack([s, q]), self.group).unbind()
            n *= dist.get_world_size(self.group)
        mean, var, inv = fold_moments(s, q, n, self.eps, self.weight)
        if not remat.bn_frozen():
            move_running(self._running(), mean, var, n)
        return normalize_plain(y, mean, inv, self.bias)

    def forward_fused(self, y: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
                      relu: bool) -> torch.Tensor:
        """:meth:`forward_moments`, then ReLU if `relu`, as one autograd node
        on the ``bn_train`` kernels (plain version on the CPU): the same
        output and running statistics; its backward returns y's whole
        cotangent, the paths through s and q included, so s and q must be
        y's own moments (not summed over a group)."""
        running = None if remat.bn_frozen() else self._running()
        return bn_train(y, s, q, self.weight, self.bias, relu, self.eps, running)

    def _running(self) -> Running:
        return Running(self.running_mean, self.running_var, self.num_batches_tracked,
                       self.momentum)


def bn_relu(x: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
    """ReLU(bn(x)).  In eval mode: the fused kernel (plain version on the
    CPU).  In training mode: the module's batch-statistics BN with the ReLU
    inside it (one ``bn_batch`` node on the card), called through the
    module so that its hooks see it."""
    if bn.training:
        return bn(x, relu=True)
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
    conv + moments kernel, then the ``bn_train`` kernels for BN and ReLU
    (torch ops where ``bn.group`` sums the moments over ranks).  A strided
    conv in training keeps ``F.conv2d``, and its BN and ReLU go through
    the module (:meth:`BatchNorm.forward`: the ``bn_batch`` kernels on the
    card).  In eval mode: ``F.conv2d``, then for a BN -> ReLU pair the
    ``bn_relu`` kernel.  In training the conv's products are the ones remat
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
        y, s, q = conv.tp_output(y), conv.tp_output(s, 0), conv.tp_output(q, 0)
        if bn.group is None:
            return bn.forward_fused(y, s, q, relu)
        y = bn.forward_moments(y, s, q)
        return F.relu(y) if relu else y
    (y,) = _kept(conv, x, w, lambda: (conv.local_conv(x, w),))
    return bn(conv.tp_output(y), relu=relu)
