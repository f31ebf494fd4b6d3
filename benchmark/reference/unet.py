"""The attention UNet in plain PyTorch, float32: tmuird/VAEUNET
``unet/unet_model.py:6-48`` and ``unet/unet_parts.py:7-103``, the
milesial/Pytorch-UNet channel plan 64 -> 1024 with a 2x2 stride-2
transposed convolution to upsample (``bilinear=False``) and the fork's
attention gate on every skip.

``Up`` upsamples x1, zero-pads it to the skip's size (left/top half of the
difference), gates the skip on it and runs DoubleConv on [gated skip, x1].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import AttentionGate, BatchNorm, Conv


class DoubleConv(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv(ci, co, 3, 1, 1, bias=False), BatchNorm(co), nn.ReLU(),
            Conv(co, co, 3, 1, 1, bias=False), BatchNorm(co), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(ci, co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.up = Conv(ci, ci // 2, 2, stride=2, transposed=True)
        self.conv = DoubleConv(ci, co)
        self.attention = AttentionGate(ci // 2, ci // 2, ci // 4)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.up(x1)
        dy, dx = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        if dy or dx:
            x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([self.attention(x1, x2), x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv = Conv(ci, co, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    """``forward(x) -> logits`` [B, n_classes, H, W]."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1):
        super().__init__()
        self.inc = DoubleConv(n_channels, 64)
        self.down1, self.down2 = Down(64, 128), Down(128, 256)
        self.down3, self.down4 = Down(256, 512), Down(512, 1024)
        self.up1, self.up2 = Up(1024, 512), Up(512, 256)
        self.up3, self.up4 = Up(256, 128), Up(128, 64)
        self.outc = OutConv(64, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.down4(x4)
        y = self.up1(y, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        return self.outc(self.up4(y, x1))
