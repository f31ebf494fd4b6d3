"""EfficientNet feature encoder (efficientnet_b4).  New in the port: the JAX
package builds only ResNet encoders.

EfficientNet-B4 (Tan & Le 2019, arXiv:1905.11946) as timm builds
``efficientnet_b4`` (``_gen_efficientnet``, channel multiplier 1.4, depth
multiplier 1.8) with ``features_only=True``, the backbone the reference's
``UNetResNet(backbone=...)`` takes from timm (``unet/unet_resnet.py``):

  stem     3x3 stride 2, 48 channels, BN + SiLU
  stage    blocks  kernel  stride  expansion  channels  feature (stride)
  0        2       3       1       1 (ds)     24        0 (2)
  1        4       3       2       6          32        1 (4)
  2        4       5       2       6          56        2 (8)
  3        6       3       2       6          112
  4        6       5       1       6          160       3 (16)
  5        8       5       2       6          272
  6        2       3       1       6          448       4 (32)

Stage 0's blocks are timm's ``DepthwiseSeparableConv``: depthwise k x k ->
BN + SiLU -> squeeze-excite -> 1x1 project -> BN.  The rest are its
``InvertedResidual`` (MBConv): 1x1 expand (x6) -> BN + SiLU -> depthwise k x
k with the stride -> BN + SiLU -> squeeze-excite -> 1x1 project -> BN.  A
block adds its input where the stride is 1 and the channels match.  The
squeeze-excite reduces to round(0.25 x the block's input channels) with a
SiLU between its two biased 1x1 convs, then gates by a sigmoid.  No
drop-path (timm's default rate 0); the classifier head (the 1792-wide 1x1
conv) is not part of ``features_only``.

Attribute names are timm's state-dict names (``conv_stem``, ``bn1``,
``blocks.<stage>.<block>.conv_pw`` / ``bn1`` / ``conv_dw`` / ``bn2`` /
``se.conv_reduce`` / ``se.conv_expand`` / ``conv_pwl`` / ``bn3``).

In training every BN runs through the module (:meth:`BatchNorm.forward`):
on the card the ``bn_batch`` kernels, with the SiLU of a BN + SiLU pair
inside them; the depthwise convs are ``ops/layers.py::DepthwiseConv``
(cuDNN), never the fused 3x3 conv + moments kernel; the squeeze-excite is
``ops/layers.py::SqueezeExcite``; the 1x1 convs are ``F.conv2d``.
``use_remat`` rematerializes each block in the backward (``ops/remat.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from vaeunet_tpu_torch.ops import remat
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, DepthwiseConv, SqueezeExcite

SE_RATIO = 0.25
# backbone name -> (stem channels, stages of (kind, blocks, kernel, stride,
# expansion, channels), the stages whose outputs are the feature maps)
EFFICIENTNET_CONFIGS = {
    "efficientnet_b4": (48, (("ds", 2, 3, 1, 1, 24), ("ir", 4, 3, 2, 6, 32),
                             ("ir", 4, 5, 2, 6, 56), ("ir", 6, 3, 2, 6, 112),
                             ("ir", 6, 5, 1, 6, 160), ("ir", 8, 5, 2, 6, 272),
                             ("ir", 2, 3, 1, 6, 448)), (0, 1, 2, 4, 6)),
}


class DepthwiseSeparable(nn.Module):
    """Depthwise k x k (s) -> BN + SiLU -> SE -> 1x1 project -> BN (+ x)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv_dw = DepthwiseConv(in_channels, kernel_size, stride)
        self.bn1 = BatchNorm(in_channels)
        self.se = SqueezeExcite(in_channels, round(in_channels * SE_RATIO))
        self.conv_pw = Conv(in_channels, out_channels, 1, bias=False)
        self.bn2 = BatchNorm(out_channels)
        self.has_skip = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.se(self.bn1(self.conv_dw(x), silu=True))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """1x1 expand -> BN + SiLU -> depthwise k x k (s) -> BN + SiLU -> SE ->
    1x1 project -> BN (+ x)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 expansion: int):
        super().__init__()
        mid = in_channels * expansion
        self.conv_pw = Conv(in_channels, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = DepthwiseConv(mid, kernel_size, stride)
        self.bn2 = BatchNorm(mid)
        self.se = SqueezeExcite(mid, round(in_channels * SE_RATIO))
        self.conv_pwl = Conv(mid, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels)
        self.has_skip = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv_pw(x), silu=True)
        y = self.se(self.bn2(self.conv_dw(y), silu=True))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


class EfficientNetEncoder(nn.Module):
    """Feature-pyramid encoder; ``forward`` returns the 5 feature maps (24,
    32, 56, 160 and 448 channels at strides 2-32 for efficientnet_b4)."""

    def __init__(self, n_channels: int = 3, backbone: str = "efficientnet_b4",
                 use_remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        stem, stages, self.feature_stages = EFFICIENTNET_CONFIGS[backbone]
        self.n_channels = n_channels
        self.use_remat = use_remat
        self.remat_policy = remat.check_policy(remat_policy)
        self.conv_stem = Conv(n_channels, stem, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(stem)
        cin = stem
        self.blocks = nn.ModuleList()
        for kind, n_blocks, k, stride, expansion, cout in stages:
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, s) if kind == "ds"
                              else InvertedResidual(cin, cout, k, s, expansion))
                cin = cout
            self.blocks.append(nn.Sequential(*blocks))
        self.feature_channels: List[int] = [stages[i][5] for i in self.feature_stages]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[1] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} input channels, got {x.shape[1]}")
        x = self.bn1(self.conv_stem(x), silu=True)
        feats = []
        for si, stage in enumerate(self.blocks):
            for block in stage:
                x = (remat.checkpoint(block, x, policy=self.remat_policy) if self.use_remat
                     else block(x))
            if si in self.feature_stages:
                feats.append(x)
        return feats
