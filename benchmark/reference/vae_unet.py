"""The VAE-UNet in plain PyTorch, float32: tmuird/VAEUNET
``unet/unet_resnet.py:103-279`` (``UNetResNet``) with a resnet34 encoder,
the latent injected at the bottleneck and at every decoder level
(``latent_injection='all'``), attention-gated skips, and the logvar head
clamped to +-30.

The resnet34 encoder is torchvision's (timm's ``features_only``): a 7x7
stride-2 stem with BN and ReLU, a 3x3 stride-2 max pool, and four stages
of 3, 4, 6 and 3 basic blocks; the five feature maps are the stem's and
each stage's.  The decoder upsamples (bilinear, align_corners=True) to the
skip's size, gates the skip, concatenates [x, gated skip, BN-ReLU(1x1(z))]
and runs two 3x3 conv-BN-ReLU; the logits (at half the input size) are
resized to the input's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import AttentionGate, BatchNorm, Conv


class BasicBlock(nn.Module):
    def __init__(self, ci: int, co: int, stride: int):
        super().__init__()
        self.conv1 = Conv(ci, co, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(co)
        self.conv2 = Conv(co, co, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(co)
        self.downsample = None
        if stride != 1 or ci != co:
            self.downsample = nn.Sequential(Conv(ci, co, 1, stride, 0, bias=False),
                                            BatchNorm(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class Encoder(nn.Module):
    """resnet34 feature pyramid: channels 64, 64, 128, 256, 512 at strides
    2, 4, 8, 16, 32."""

    def __init__(self, n_channels: int = 3, stages: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv(n_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        ci = 64
        for si, (n, co) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                blocks.append(BasicBlock(ci, co, 2 if si > 0 and bi == 0 else 1))
                ci = co
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.channels = [64, 64, 128, 256, 512]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class DecoderBlock(nn.Module):
    def __init__(self, ci: int, skip: int, co: int, latent: int):
        super().__init__()
        self.z_proj = nn.Sequential(Conv(latent, latent, 1), BatchNorm(latent))
        self.attention = AttentionGate(ci, skip, ci // 4)
        self.conv1 = nn.Sequential(Conv(ci + skip + latent, co, 3, 1, 1, bias=False),
                                   BatchNorm(co))
        self.conv2 = nn.Sequential(Conv(co, co, 3, 1, 1, bias=False), BatchNorm(co))

    def forward(self, x: torch.Tensor, skip: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        hw = tuple(skip.shape[2:])
        x = F.interpolate(x, size=hw, mode="bilinear", align_corners=True)
        gated = self.attention(x, skip)
        zmap = z[:, :, None, None].expand(-1, -1, *hw)
        zp = F.relu(self.z_proj[1](self.z_proj[0](zmap)))
        y = torch.cat([x, gated, zp], dim=1)
        y = F.relu(self.conv1[1](self.conv1[0](y)))
        return F.relu(self.conv2[1](self.conv2[0](y)))


class VAEUNet(nn.Module):
    """``forward(x, eps) -> (logits, mu, logvar)`` with z = mu + eps *
    exp(logvar / 2); x [B, 3, H, W] float32, eps [B, latent]."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, latent_dim: int = 32,
                 logvar_clamp: float = 30.0, encoder_stages: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.latent_dim = latent_dim
        self.logvar_clamp = logvar_clamp
        self.encoder = Encoder(n_channels, encoder_stages)
        ch = self.encoder.channels
        self.mu_head = nn.Sequential(Conv(ch[-1], latent_dim, 1))
        self.logvar_head = nn.Sequential(Conv(ch[-1], latent_dim, 1))
        self.z_initial = nn.Sequential(Conv(latent_dim, ch[-1], 1), BatchNorm(ch[-1]))
        plans = [(ch[-1], ch[-2], 512), (512, ch[-3], 256), (256, ch[-4], 128), (128, ch[0], 64)]
        self.decoder_blocks = nn.ModuleList(
            [DecoderBlock(ci, sk, co, latent_dim) for ci, sk, co in plans])
        self.final_conv = Conv(64, n_classes, 1)

    def heads(self, bottom: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.mu_head(bottom).mean(dim=(2, 3))
        logvar = self.logvar_head(bottom).mean(dim=(2, 3))
        return mu, torch.clamp(logvar, -self.logvar_clamp, self.logvar_clamp)

    def decode(self, z: torch.Tensor, feats: Sequence[torch.Tensor],
               out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        bottom = feats[-1]
        zmap = z[:, :, None, None].expand(-1, -1, *bottom.shape[2:])
        x = F.relu(self.z_initial[1](self.z_initial[0](zmap)))
        for i, block in enumerate(self.decoder_blocks):
            x = block(x, feats[-(i + 2)], z)
        logits = self.final_conv(x)
        if out_hw is not None and tuple(out_hw) != tuple(logits.shape[2:]):
            logits = F.interpolate(logits, size=out_hw, mode="bilinear", align_corners=True)
        return logits

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        feats = self.encoder(x)
        mu, logvar = self.heads(feats[-1])
        z = mu + eps * torch.exp(0.5 * logvar)
        return self.decode(z, feats, tuple(x.shape[2:])), mu, logvar
