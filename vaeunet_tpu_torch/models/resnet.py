"""ResNet feature encoder (resnet18/34).  Port of
``vaeunet_tpu/models/resnet.py``.

Returns the 5 feature maps the reference gets from
``timm.create_model('resnet34', features_only=True)``:

  index  source                stride  channels
  0      stem act (conv7x7/2)  2       64
  1      layer1                4       64
  2      layer2                8       128
  3      layer3                16      256
  4      layer4                32      512

Attribute names are the reference state-dict names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ...).  The stem BN and every
block's ``bn1`` are BN -> ReLU pairs and go through :func:`bn_relu` in eval
mode.  In training, every stride-1 3x3 conv -> BN pair (each block's
``conv2``/``bn2`` and the stride-1 ``conv1``/``bn1``) goes through
:func:`conv3x3_bn`, the fused conv + moments kernel: 29 per resnet34
forward.  The stem 7x7 and the stride-2 ``conv1``s keep ``F.conv2d`` and a
batch-statistics BN.  The bottleneck backbones (resnet50/101) are not
ported yet.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

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


class ResNetEncoder(nn.Module):
    """Feature-pyramid encoder; ``forward`` returns the 5 feature maps."""

    def __init__(self, n_channels: int = 3, backbone: str = "resnet34",
                 stage_features=(64, 128, 256, 512)):
        super().__init__()
        stage_sizes, bottleneck = RESNET_CONFIGS[backbone]
        if bottleneck:
            raise ValueError(f"{backbone}: bottleneck backbones are not ported yet")
        self.n_channels = n_channels
        self.feature_channels: List[int] = [64, *stage_features]
        self.conv1 = Conv(n_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for si, (n_blocks, features) in enumerate(zip(stage_sizes, stage_features)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(BasicBlock(cin, features, stride))
                cin = features
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[1] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} input channels, got {x.shape[1]}")
        x = bn_relu(self.conv1(x), self.bn1)
        feats = [x]                                   # stride 2
        x = max_pool(x, window=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)                           # strides 4, 8, 16, 32
        return feats
