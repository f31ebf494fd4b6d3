"""The EfficientNet-B4 VAE-UNet in plain PyTorch, float32: tmuird/VAEUNET
``unet/unet_resnet.py:103-279`` (``UNetResNet``) around timm's
``features_only`` ``efficientnet_b4`` (Tan & Le 2019, arXiv:1905.11946;
timm's ``_gen_efficientnet`` with channel multiplier 1.4 and depth
multiplier 1.8).

The encoder: a 3x3 stride-2 stem of 48 channels with BN and SiLU, then 32
blocks in 7 stages of 2, 4, 4, 6, 6, 8 and 2 blocks, of 24, 32, 56, 112,
160, 272 and 448 channels, kernels 3, 3, 5, 3, 5, 5, 3, strides 1, 2, 2,
2, 1, 2, 1 (the stride on a stage's first block), padding k // 2.  Stage
0's blocks are depthwise k x k -> BN -> SiLU -> squeeze-excite -> 1x1
project -> BN; the others expand x6 first (1x1 -> BN -> SiLU) and project
after.  The squeeze-excite is the mean over H and W, a 1x1 conv with bias to
round(0.25 x the block's input channels), SiLU, a 1x1 conv with bias back,
and a sigmoid gate.  A block adds its input where its stride is 1 and its
channels do not change.  BN: momentum 0.1, eps 1e-5.  The feature maps are
stages 0, 1, 2, 4 and 6: 24, 32, 56, 160 and 448 channels at strides 2 to
32, so the decoder's first convs take 448 + 160 + 32 = 640, then 512 + 56 +
32 = 600, 320 and 184 channels.  Heads, the latent at every decoder level,
the gated skips and the decoder blocks are :mod:`benchmark.reference.
vae_unet`'s, each encoder and decoder block recomputed in the backward as
in :mod:`benchmark.reference.bottleneck`.

The depthwise conv is :class:`DepthwiseConv`, a :class:`Conv` with
``groups``: its weight is [C, 1, k, k], so the seeded weights take
PyTorch's fan-in k^2 and a control's rounding (``quant``) reaches it.  It
keeps its stride and padding as pairs: the harness's count of the dense
stride-1 3x3 sites (``harness/flops.py::conv3x3_sites``, which matches
``stride == 1`` and ``padding == 1``) is of the convolutions the fused conv
+ BN statistics kernel computes, and no depthwise conv is one.

Departures from timm's ``efficientnet_b4``: the weights are drawn from the
seed (PyTorch's default init), not timm's ImageNet weights; drop-path is 0
(timm's default for ``create_model``); the logvar head is clamped to +-30,
as in the resnet34 reference.  It runs with TF32 off: the training driver
sets both TF32 flags off before it builds a reference (``drivers/train.py::
follow_reference``), and the forward refuses a CUDA input while cuDNN's
flag is on.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.bottleneck import BottleneckVAEUNet, recomputed
from benchmark.reference.layers import ROUNDING, BatchNorm, Conv, _RoundBf16
from benchmark.reference.vae_unet import DecoderBlock

SE_RATIO = 0.25
STEM = 48
# (blocks, kernel, stride, expansion, channels) a stage
STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (2, 3, 1, 1, 24), (4, 3, 2, 6, 32), (4, 5, 2, 6, 56), (6, 3, 2, 6, 112),
    (6, 5, 1, 6, 160), (8, 5, 2, 6, 272), (2, 3, 1, 6, 448))
FEATURE_STAGES = (0, 1, 2, 4, 6)


class DepthwiseConv(Conv):
    """A bias-free depthwise k x k convolution: weight [C, 1, k, k]."""

    def __init__(self, c: int, k: int, stride: int):
        super().__init__(1, c, k, bias=False)
        self.stride, self.padding = (stride, stride), (k // 2, k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = ROUNDING[self.quant]
        y = F.conv2d(q(x), q(self.weight), None, self.stride, self.padding,
                     groups=self.weight.shape[0])
        return _RoundBf16.apply(y) if self.quant == "bf16" else y


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv(c, reduced, 1)
        self.conv_expand = Conv(reduced, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(s))


class Block(nn.Module):
    """An MBConv block (``expansion`` > 1: timm's ``InvertedResidual``) or a
    depthwise-separable one (``expansion`` 1: its ``DepthwiseSeparableConv``,
    no expand conv, the project conv named ``conv_pw``)."""

    def __init__(self, ci: int, co: int, k: int, stride: int, expansion: int):
        super().__init__()
        self.expand = expansion != 1
        mid = ci * expansion
        if self.expand:
            self.conv_pw = Conv(ci, mid, 1, bias=False)
            self.bn1 = BatchNorm(mid)
            self.conv_dw = DepthwiseConv(mid, k, stride)
            self.bn2 = BatchNorm(mid)
            self.se = SqueezeExcite(mid, round(ci * SE_RATIO))
            self.conv_pwl = Conv(mid, co, 1, bias=False)
            self.bn3 = BatchNorm(co)
        else:
            self.conv_dw = DepthwiseConv(ci, k, stride)
            self.bn1 = BatchNorm(ci)
            self.se = SqueezeExcite(ci, round(ci * SE_RATIO))
            self.conv_pw = Conv(ci, co, 1, bias=False)
            self.bn2 = BatchNorm(co)
        self.skip = stride == 1 and ci == co

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = self.se(F.silu(self.bn2(self.conv_dw(y))))
            y = self.bn3(self.conv_pwl(y))
        else:
            y = self.se(F.silu(self.bn1(self.conv_dw(x))))
            y = self.bn2(self.conv_pw(y))
        return y + x if self.skip else y


class Encoder(nn.Module):
    """efficientnet_b4 feature pyramid: channels 24, 32, 56, 160, 448 at
    strides 2, 4, 8, 16, 32."""

    def __init__(self, n_channels: int = 3):
        super().__init__()
        self.conv_stem = Conv(n_channels, STEM, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(STEM)
        ci = STEM
        self.blocks = nn.ModuleList()
        for n, k, stride, expansion, co in STAGES:
            stage = []
            for bi in range(n):
                stage.append(Block(ci, co, k, stride if bi == 0 else 1, expansion))
                ci = co
            self.blocks.append(nn.Sequential(*stage))
        self.channels = [STAGES[i][4] for i in FEATURE_STAGES]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(x)))
        feats = []
        for si, stage in enumerate(self.blocks):
            for block in stage:
                x = recomputed(block, x)
            if si in FEATURE_STAGES:
                feats.append(x)
        return feats


class EfficientNetVAEUNet(BottleneckVAEUNet):
    """``forward(x, eps) -> (logits, mu, logvar)``, the VAE-UNet's heads,
    forward and recomputed decoder around the efficientnet_b4 encoder."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, latent_dim: int = 32,
                 logvar_clamp: float = 30.0):
        nn.Module.__init__(self)    # the parents' own __init__ build their ResNet encoders
        self.latent_dim = latent_dim
        self.logvar_clamp = logvar_clamp
        self.encoder = Encoder(n_channels)
        ch = self.encoder.channels
        self.mu_head = nn.Sequential(Conv(ch[-1], latent_dim, 1))
        self.logvar_head = nn.Sequential(Conv(ch[-1], latent_dim, 1))
        self.z_initial = nn.Sequential(Conv(latent_dim, ch[-1], 1), BatchNorm(ch[-1]))
        plans = [(ch[-1], ch[-2], 512), (512, ch[-3], 256), (256, ch[-4], 128), (128, ch[0], 64)]
        self.decoder_blocks = nn.ModuleList(
            [DecoderBlock(ci, sk, co, latent_dim) for ci, sk, co in plans])
        self.final_conv = Conv(64, n_classes, 1)

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        if x.is_cuda and torch.backends.cudnn.allow_tf32:
            raise RuntimeError("the reference runs with TF32 off (torch.backends.cudnn.allow_tf32)")
        return super().forward(x, eps)

