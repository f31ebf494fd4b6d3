"""ResNet feature encoder (resnet18/34/50/101).  Port of
``vaeunet_tpu/models/resnet.py``.

Returns the 5 feature maps the reference gets from
``timm.create_model('resnet34', features_only=True)``:

  index  source                stride  channels (resnet18/34, resnet50/101)
  0      stem act (conv7x7/2)  2       64, 64
  1      layer1                4       64, 256
  2      layer2                8       128, 512
  3      layer3                16      256, 1024
  4      layer4                32      512, 2048

Attribute names are the reference state-dict names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, a bottleneck's ``conv3`` /
``bn3``, ...).  The stem BN and every BN -> ReLU pair of a block go through
:func:`bn_relu` in eval mode.  In training, every stride-1 3x3 conv -> BN
pair goes through :func:`conv3x3_bn`, the fused conv + moments kernel: a
basic block's ``conv2`` and stride-1 ``conv1`` (29 per resnet34 forward),
a bottleneck block's stride-1 ``conv2`` (13 per resnet50 forward).  The
stem 7x7, the 1x1 convs and the stride-2 3x3 convs keep ``F.conv2d``, and
their BNs run through the module, which on the card is the ``bn_batch``
kernels (a moments pass, then the normalisation), the ReLU of a BN -> ReLU
pair inside them; the residual add and its ReLU stay torch ops.

``use_remat`` rematerializes each residual block in the backward
(``ops/remat.py``; the JAX ``nn.remat`` of ``resnet.py:118-141``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import remat
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, bn_relu, conv3x3_bn
from vaeunet_tpu_torch.ops.pool import max_pool

# backbone name -> (stage sizes, bottleneck?)
RESNET_CONFIGS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
}


class BasicBlock(nn.Module):
    """conv3x3(s)-BN-ReLU-conv3x3-BN + identity/1x1-downsample, ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(
                Conv(in_channels, features, 1, stride=stride, bias=False),
                BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = conv3x3_bn(self.conv1, self.bn1, x, relu=True)
        y = conv3x3_bn(self.conv2, self.bn2, y, relu=False)
        return F.relu(y + identity)


class BottleneckBlock(nn.Module):
    """1x1 reduce - BN - ReLU - 3x3(s) - BN - ReLU - 1x1 expand (x4) - BN
    + identity/1x1-downsample, ReLU (the stride on ``conv2``)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out_features = self.expansion * features
        self.conv1 = Conv(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, out_features, 1, bias=False)
        self.bn3 = BatchNorm(out_features)
        self.downsample = None
        if stride != 1 or in_channels != out_features:
            self.downsample = nn.Sequential(
                Conv(in_channels, out_features, 1, stride=stride, bias=False),
                BatchNorm(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = bn_relu(self.conv1(x), self.bn1)
        y = conv3x3_bn(self.conv2, self.bn2, y, relu=True)
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


class ResNetEncoder(nn.Module):
    """Feature-pyramid encoder; ``forward`` returns the 5 feature maps."""

    def __init__(self, n_channels: int = 3, backbone: str = "resnet34",
                 stage_features=(64, 128, 256, 512), use_remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        stage_sizes, bottleneck = RESNET_CONFIGS[backbone]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        mult = BottleneckBlock.expansion if bottleneck else 1
        self.n_channels = n_channels
        self.use_remat = use_remat
        self.remat_policy = remat.check_policy(remat_policy)
        self.feature_channels: List[int] = [64, *(f * mult for f in stage_features)]
        self.conv1 = Conv(n_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for si, (n_blocks, features) in enumerate(zip(stage_sizes, stage_features)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(block_cls(cin, features, stride))
                cin = features * mult
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[1] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} input channels, got {x.shape[1]}")
        x = bn_relu(self.conv1(x), self.bn1)
        feats = [x]                                   # stride 2
        x = max_pool(x, window=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = (remat.checkpoint(block, x, policy=self.remat_policy) if self.use_remat
                     else block(x))
            feats.append(x)                           # strides 4, 8, 16, 32
        return feats
