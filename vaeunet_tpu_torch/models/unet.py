"""Plain U-Net (the milesial channel plan).  Port of
``vaeunet_tpu/models/unet.py`` (reference ``unet/unet_model.py:6-48``):
4 down and 4 up stages, 64 -> 1024 channels (1024 // 2 at the bottom when
bilinear), attention-gated skips, a 1x1 out conv.

``use_remat`` rematerializes each stage in the backward (``ops/remat.py``,
policy 'full'; the JAX ``nn.remat`` of ``unet.py:30-36``, which takes no
policy).  Per forward: 18 fused conv + moments launches in training,
18 ``bn_relu`` launches in eval, and with ``bilinear`` 4 resizes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vaeunet_tpu_torch.device import resolve_device, use_fp32_numerics
from vaeunet_tpu_torch.models.parts import DoubleConv, Down, OutConv, Up
from vaeunet_tpu_torch.ops import remat


class UNet(nn.Module):
    """``forward(x)`` -> logits [B, n_classes, H, W] for x [B, n_channels,
    H, W] (channels_last)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, bilinear: bool = False,
                 use_remat: bool = False):
        super().__init__()
        self.n_channels = n_channels
        self.n_classes = n_classes
        self.bilinear = bilinear
        self.use_remat = use_remat
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // factor)
        self.up1 = Up(1024, 512 // factor, bilinear)
        self.up2 = Up(512, 256 // factor, bilinear)
        self.up3 = Up(256, 128 // factor, bilinear)
        self.up4 = Up(128, 64, bilinear)
        self.outc = OutConv(64, n_classes)

    def _stage(self, stage: nn.Module, *args) -> torch.Tensor:
        if self.use_remat:
            return remat.checkpoint(stage, *args)
        return stage(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} input channels, got {x.shape[1]}")
        x1 = self._stage(self.inc, x)
        x2 = self._stage(self.down1, x1)
        x3 = self._stage(self.down2, x2)
        x4 = self._stage(self.down3, x3)
        x5 = self._stage(self.down4, x4)
        y = self._stage(self.up1, x5, x4)
        y = self._stage(self.up2, y, x3)
        y = self._stage(self.up3, y, x2)
        y = self._stage(self.up4, y, x1)
        return self.outc(y)


def build_unet(n_channels: int = 3, n_classes: int = 1, bilinear: bool = False,
               use_remat: bool = False, seed: int = 0, device=None) -> UNet:
    """A ``UNet`` with PyTorch-default init drawn from `seed`, in eval mode
    and channels_last memory on `device` (CUDA unless ``"cpu"``)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNet(n_channels, n_classes, bilinear=bilinear, use_remat=use_remat)
    if device.type == "cuda":
        use_fp32_numerics()
    return model.to(device=device, memory_format=torch.channels_last).eval()
