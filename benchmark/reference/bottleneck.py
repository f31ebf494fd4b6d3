"""The resnet50 VAE-UNet in plain PyTorch, float32: tmuird/VAEUNET
``unet/unet_resnet.py:103-279`` (``UNetResNet(backbone='resnet50')``), whose
encoder is timm's ``features_only`` resnet50 (He et al. 2016,
arXiv:1512.03385, in its v1.5 form: the stride on the 3x3).

A bottleneck block is 1x1 reduce -> BN -> ReLU -> 3x3 (stride 2 in the
first block of stages 2-4) -> BN -> ReLU -> 1x1 expand x4 -> BN, plus a 1x1
stride-s projection with BN where the shape changes, then ReLU.  The stem
(7x7 stride 2, BN, ReLU, 3x3 stride-2 max pool) and four stages of 3, 4, 6
and 3 blocks at widths 64, 128, 256 and 512 give feature maps of 64, 256,
512, 1024 and 2048 channels.  The decoder's plan follows from them: the
first decoder conv takes 2048 + 1024 + 32 = 3104 channels, then 1056, 544
and 224.  Heads, the latent injection at every decoder level, the gated
skips and the decoder blocks are :mod:`benchmark.reference.vae_unet`'s.

Departures from the published model: the weights are drawn from the seed
(PyTorch's default init), not timm's ImageNet weights; the logvar head is
clamped to +-30, as in the resnet34 reference.

Where a backward will run on a device, each encoder block and each decoder
block keeps only its inputs and recomputes its activations in the backward
(``torch.utils.checkpoint``), the same arithmetic in less memory: the
float32 step at the cell's batch 32 and 512^2 otherwise fills the card's
80 GB, and the controls round every conv's operands into further copies.
The recompute moves the training BNs' running statistics a second time,
which nothing compared reads.  On the meta device, where the FLOP counts
are taken, nothing is recomputed, so nothing is counted twice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.layers import BatchNorm, Conv
from benchmark.reference.vae_unet import DecoderBlock, VAEUNet

EXPANSION = 4


def recomputed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward where one
    will run off the meta device."""
    if torch.is_grad_enabled() and args[0].device.type != "meta":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Bottleneck(nn.Module):
    def __init__(self, ci: int, width: int, stride: int):
        super().__init__()
        co = width * EXPANSION
        self.conv1 = Conv(ci, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, co, 1, bias=False)
        self.bn3 = BatchNorm(co)
        self.downsample = None
        if stride != 1 or ci != co:
            self.downsample = nn.Sequential(Conv(ci, co, 1, stride, 0, bias=False),
                                            BatchNorm(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class Encoder(nn.Module):
    """resnet50 feature pyramid: channels 64, 256, 512, 1024, 2048 at strides
    2, 4, 8, 16, 32."""

    def __init__(self, n_channels: int = 3, stages: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv(n_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        ci = 64
        for si, (n, width) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(ci, width, 2 if si > 0 and bi == 0 else 1))
                ci = width * EXPANSION
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.channels = [64] + [w * EXPANSION for w in (64, 128, 256, 512)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = recomputed(block, x)
            feats.append(x)
        return feats


class BottleneckVAEUNet(VAEUNet):
    """``forward(x, eps) -> (logits, mu, logvar)``, as :class:`VAEUNet`'s
    (whose heads and forward it runs), around the resnet50 encoder."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, latent_dim: int = 32,
                 logvar_clamp: float = 30.0, encoder_stages: Sequence[int] = (3, 4, 6, 3)):
        nn.Module.__init__(self)    # VAEUNet's own __init__ builds the basic-block encoder
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

    def decode(self, z: torch.Tensor, feats: Sequence[torch.Tensor],
               out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """:meth:`VAEUNet.decode`, each decoder block recomputed in the backward."""
        bottom = feats[-1]
        zmap = z[:, :, None, None].expand(-1, -1, *bottom.shape[2:])
        x = F.relu(self.z_initial[1](self.z_initial[0](zmap)))
        for i, block in enumerate(self.decoder_blocks):
            x = recomputed(block, x, feats[-(i + 2)], z)
        logits = self.final_conv(x)
        if out_hw is not None and tuple(out_hw) != tuple(logits.shape[2:]):
            logits = F.interpolate(logits, size=out_hw, mode="bilinear", align_corners=True)
        return logits
