"""U-Net building blocks.  Port of ``vaeunet_tpu/models/parts.py``
(reference ``unet/unet_parts.py``):

- AttentionGate   <- unet_parts.py:7-30 (also the VAE-UNet's gate)
- DoubleConv      <- unet_parts.py:32-49
- Down            <- unet_parts.py:51-63
- Up              <- unet_parts.py:65-95 (bilinear or transpose-conv,
                     asymmetric pad-to-match, attention-gated skip)
- OutConv         <- unet_parts.py:97-103

Tensors are NCHW in ``torch.channels_last`` memory.  Attribute names are
the reference state-dict names (``double_conv.{0,1,3,4}``,
``maxpool_conv.1``, ``up``, ``attention.W_g.0``, ``conv``), which
``vaeunet_tpu.compat.torch_weights.convert_unet_state_dict`` reads.

Both 3x3 convs of a :class:`DoubleConv` go through
:func:`~vaeunet_tpu_torch.ops.layers.conv3x3_bn`: the fused conv + moments
kernel in training, ``F.conv2d`` and the ``bn_relu`` kernel in eval.  The
gate's three training BNs take the ``bn_batch`` kernels on the card
(``BatchNorm.forward``); its ``relu(BN + BN)`` stays a torch op.  The
bilinear upsample is the resize kernel (``ops/resize.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, ConvTranspose2x, conv3x3_bn
from vaeunet_tpu_torch.ops.pool import max_pool
from vaeunet_tpu_torch.ops.resize import upsample2x_bilinear_align_corners


class AttentionGate(nn.Module):
    """Additive attention gate, psi = sigmoid(BN(1x1(relu(BN(1x1(g)) +
    BN(1x1(x)))))), returning x * psi: g is the upsampled decoder feature,
    x the skip.  ``psi`` ends in its sigmoid, so a forward hook on ``psi``
    sees the attention map (``models/vae_unet.py::capture_attention``)."""

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(Conv(f_g, f_int, 1), BatchNorm(f_int))
        self.W_x = nn.Sequential(Conv(f_l, f_int, 1), BatchNorm(f_int))
        self.psi = nn.Sequential(Conv(f_int, 1, 1), BatchNorm(1), nn.Sigmoid())

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = F.relu(self.W_g(g) + self.W_x(x))
        return x * self.psi(psi)


class DoubleConv(nn.Module):
    """(3x3 conv bias=False -> BN -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            Conv(in_channels, mid, 3, padding=1, bias=False), BatchNorm(mid), nn.ReLU(),
            Conv(mid, out_channels, 3, padding=1, bias=False), BatchNorm(out_channels),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dc = self.double_conv
        x = conv3x3_bn(dc[0], dc[1], x, relu=True)
        return conv3x3_bn(dc[3], dc[4], x, relu=True)


class Down(nn.Module):
    """MaxPool(2), then DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv[1](max_pool(x, window=2))


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1's H and W up to x2's in ``F.pad`` order: left (top) =
    diff // 2, right (bottom) = the rest."""
    dh = x2.shape[2] - x1.shape[2]
    dw = x2.shape[3] - x1.shape[3]
    if dh == 0 and dw == 0:
        return x1
    x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return x1.contiguous(memory_format=torch.channels_last)


class Up(nn.Module):
    """Upsample x1 (bilinear, align_corners, or a 2x2 transposed conv), pad
    it to the skip's size, gate the skip on it, concatenate [skip, x1] and
    DoubleConv.  The reference gates the skip in the plain UNet too, and so
    does this port (SURVEY.md section 2.3)."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = True):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)
        else:
            self.up = ConvTranspose2x(in_channels, in_channels // 2)
            self.conv = DoubleConv(in_channels, out_channels)
        half = in_channels // 2           # channels of both the upsampled x1 and the skip
        self.attention = AttentionGate(half, half, in_channels // 4)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = upsample2x_bilinear_align_corners(x1) if self.bilinear else self.up(x1)
        x1 = _pad_to_match(x1, x2)
        x2 = self.attention(x1, x2)
        x = torch.cat([x2, x1], dim=1).contiguous(memory_format=torch.channels_last)
        return self.conv(x)


class OutConv(nn.Module):
    """1x1 output conv."""

    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.conv = Conv(in_channels, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
