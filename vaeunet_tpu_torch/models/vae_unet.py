"""VAE-UNet: ResNet- or EfficientNet-encoder U-Net with a variational
bottleneck.  Port of ``vaeunet_tpu/models/vae_unet.py`` (reference
``unet/unet_resnet.py``).

Tensors are NCHW in ``torch.channels_last`` memory.  Attribute names are
the reference state-dict names (``mu_head.0``, ``z_initial.1``,
``decoder_blocks.0.conv1.0``, ``decoder_blocks.0.attention.W_g.0``, ...), so
``vaeunet_tpu.compat.torch_weights.convert_unet_resnet_state_dict`` reads
this model's ``state_dict()`` and ``compat/jax_weights.py`` writes it.

The decoder computes the reference's concatenation form: upsample, gate the
skip, concatenate [x, skip, z_proj(z)], conv.  The JAX package's default
``fused_decoder=True`` lowering (``SlicedConv.constant_input_term`` and the
pre-upsample gate) is an exact rewrite of it with the same parameters.

Every eval BN -> ReLU pair (``z_initial``, ``z_proj``, decoder ``bn1`` /
``bn2`` and the encoder's) goes through the fused kernel; the gate BNs and
the BNs before a residual add are plain ``nn.BatchNorm2d``.  In training,
the decoder's ``conv1``/``bn1`` and ``conv2``/``bn2`` take the fused conv +
moments kernel (:func:`conv3x3_bn`, 8 per forward); every other training BN
(``z_initial`` and ``z_proj`` with their ReLU inside, the gates' three, the
encoder's off the fused sites) takes the ``bn_batch`` kernels through
:meth:`BatchNorm.forward` on the card, torch's BN on the CPU.  The ``z_proj`` BN
sees the latent broadcast over B x H x W, so its unbiased running-variance
factor uses that count, which is what the JAX fused decoder's
``virtual_n=b*h*w`` restores (``vae_unet.py:196-202``).

The backbone name picks the encoder (:func:`build_encoder`):
resnet18/34/50/101 (``models/resnet.py``) or efficientnet_b4
(``models/efficientnet.py``, which the JAX package does not have).  The
encoder's channels set the decoder's plan (JAX ``vae_unet.py:282-295``):
resnet50/101 give a 2048-wide ``z_initial`` and a first decoder conv of
2048 + 1024 + 32 input channels, efficientnet_b4 a 448-wide one and 448 +
160 + 32.  ``deep_supervision`` adds three 1x1 heads
(``ds_heads.{0,1,2}``) on decoder levels 0-2, whose logits the forward
hands out only when asked (``intermediates=``), as the JAX ``sow`` costs
nothing unless ``'intermediates'`` is requested.  ``use_remat``
rematerializes each residual and decoder block (``ops/remat.py``,
``remat_policy`` 'full' or 'save_convs').

Injection strategies (unet_resnet.py:104-123):
  'all'                  bottleneck + all 4 decoder levels
  'first'                bottleneck + level 0
  'last'                 bottleneck + level 3
  'bottleneck'           bottleneck only
  'inject_no_bottleneck' levels 0-3, decoder starts from encoder features
  'none'                 no injection anywhere (z = mu, deterministic)
  (i0, i1, ...)          bottleneck + the listed 0-based levels
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from vaeunet_tpu_torch.device import resolve_device, use_fp32_numerics
from vaeunet_tpu_torch.models.efficientnet import EFFICIENTNET_CONFIGS, EfficientNetEncoder
from vaeunet_tpu_torch.models.parts import AttentionGate
from vaeunet_tpu_torch.models.resnet import RESNET_CONFIGS, ResNetEncoder
from vaeunet_tpu_torch.ops import remat
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, bn_relu, conv3x3_bn
from vaeunet_tpu_torch.ops.pool import avg_pool_global
from vaeunet_tpu_torch.ops.resize import broadcast_latent_spatial, resize_bilinear
from vaeunet_tpu_torch.ops.sampling import gaussian_like

LatentInjection = Union[str, Tuple[int, ...]]


def build_encoder(n_channels: int, backbone: str, use_remat: bool = False,
                  remat_policy: str = "full") -> nn.Module:
    """The feature encoder of `backbone`: a ResNet or an EfficientNet, each
    with ``feature_channels`` and a forward returning its 5 feature maps."""
    if backbone in RESNET_CONFIGS:
        return ResNetEncoder(n_channels, backbone=backbone, use_remat=use_remat,
                             remat_policy=remat_policy)
    if backbone in EFFICIENTNET_CONFIGS:
        return EfficientNetEncoder(n_channels, backbone=backbone, use_remat=use_remat,
                                   remat_policy=remat_policy)
    raise ValueError(f"unknown backbone {backbone!r}: expected one of "
                     f"{sorted(RESNET_CONFIGS) + sorted(EFFICIENTNET_CONFIGS)}")


def resolve_injection(latent_injection: LatentInjection) -> Tuple[Tuple[bool, ...], bool, bool]:
    """-> (use_latent per decoder level, use_bottleneck, should_sample).

    Mirrors unet_resnet.py:156-175 and :210 exactly, including the fallback of
    unknown strings to 'all'.
    """
    if isinstance(latent_injection, (tuple, list)):
        use_latent = tuple(i in tuple(latent_injection) for i in range(4))
        return use_latent, True, True
    s = latent_injection
    if s in ("all", "inject_no_bottleneck"):
        use_latent = (True, True, True, True)
    elif s == "first":
        use_latent = (True, False, False, False)
    elif s == "last":
        use_latent = (False, False, False, True)
    elif s in ("bottleneck", "none"):
        use_latent = (False, False, False, False)
    else:  # unknown -> 'all' (reference behavior)
        use_latent = (True, True, True, True)
        s = "all"
    use_bottleneck = s not in ("none", "inject_no_bottleneck")
    should_sample = s not in ("none", "inject_no_bottleneck")
    return use_latent, use_bottleneck, should_sample


class DecoderBlock(nn.Module):
    """Upsample -> (attention-gated) skip concat -> optional z concat ->
    (3x3 conv + BN + ReLU) x 2.  (unet_resnet.py:31-101)"""

    def __init__(self, in_channels: int, out_channels: int, latent_dim: int,
                 use_attention: bool = True, use_skip: bool = True,
                 use_latent: bool = True, skip_channels: int = 0):
        super().__init__()
        self.use_skip = use_skip
        self.use_latent = use_latent
        self.use_attention = use_attention and use_skip
        if use_latent:
            self.z_proj = nn.Sequential(Conv(latent_dim, latent_dim, 1), BatchNorm(latent_dim))
        if self.use_attention:
            self.attention = AttentionGate(in_channels, skip_channels, in_channels // 4)
        total_in = (in_channels + (skip_channels if use_skip else 0)
                    + (latent_dim if use_latent else 0))
        self.conv1 = nn.Sequential(Conv(total_in, out_channels, 3, padding=1, bias=False),
                                   BatchNorm(out_channels))
        self.conv2 = nn.Sequential(Conv(out_channels, out_channels, 3, padding=1, bias=False),
                                   BatchNorm(out_channels))

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                z: Optional[torch.Tensor]) -> torch.Tensor:
        """x: [B,Cin,h,w]; skip: [B,Cs,H,W] or None; z: [B,D] or None."""
        if skip is not None:
            out_hw = tuple(skip.shape[2:])
        else:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        x = resize_bilinear(x, out_hw, align_corners=True)
        components = [x]
        if skip is not None and self.use_skip:
            if self.use_attention:
                skip = self.attention(x, skip)
            components.append(skip)
        if self.use_latent:
            z_sp = self.z_proj[0](broadcast_latent_spatial(z, out_hw))
            components.append(bn_relu(z_sp, self.z_proj[1]))
        y = torch.cat(components, dim=1)
        y = conv3x3_bn(self.conv1[0], self.conv1[1], y, relu=True)
        return conv3x3_bn(self.conv2[0], self.conv2[1], y, relu=True)


class UNetResNet(nn.Module):
    """VAE-UNet flagship model.  (unet_resnet.py:103-279)

    ``forward`` returns (logits, mu, logvar) like the reference; pass a
    ``torch.Generator`` when sampling is active.
    """

    def __init__(self, n_channels: int = 3, n_classes: int = 1, backbone: str = "resnet34",
                 latent_dim: int = 32, use_attention: bool = True, use_skip: bool = True,
                 latent_injection: LatentInjection = "all",
                 logvar_clamp: Optional[float] = 30.0, use_remat: bool = False,
                 remat_policy: str = "full", deep_supervision: bool = False):
        super().__init__()
        use_latent, self.use_bottleneck, self.should_sample = resolve_injection(
            latent_injection)
        self.use_remat = use_remat
        self.remat_policy = remat.check_policy(remat_policy)
        self.deep_supervision = deep_supervision
        self.n_channels = n_channels
        self.latent_dim = latent_dim
        self.latent_injection = latent_injection
        self.use_skip = use_skip
        # |logvar| cap at the head (vae_unet.py:256-262): keeps sampling
        # finite where the reference's KL clamp lets logvar drift.
        self.logvar_clamp = logvar_clamp

        self.encoder = build_encoder(n_channels, backbone, use_remat, remat_policy)
        enc_ch = self.encoder.feature_channels           # resnet34: [64,64,128,256,512]
        self.mu_head = nn.Sequential(Conv(enc_ch[-1], latent_dim, 1))
        self.logvar_head = nn.Sequential(Conv(enc_ch[-1], latent_dim, 1))
        bott = enc_ch[-1]
        self.z_initial = nn.Sequential(Conv(latent_dim, bott, 1), BatchNorm(bott))
        plans = [  # (in_ch, skip_ch, out_ch) per unet_resnet.py:181-186
            (bott, enc_ch[-2], 512),
            (512, enc_ch[-3], 256),
            (256, enc_ch[-4], 128),
            (128, enc_ch[0], 64),
        ]
        self.decoder_blocks = nn.ModuleList([
            DecoderBlock(in_ch, out_ch, latent_dim,
                         use_attention=use_attention and use_skip, use_skip=use_skip,
                         use_latent=use_latent[i], skip_channels=skip_ch)
            for i, (in_ch, skip_ch, out_ch) in enumerate(plans)
        ])
        self.final_conv = Conv(64, n_classes, 1)
        if deep_supervision:
            self.ds_heads = nn.ModuleList([Conv(plans[i][2], n_classes, 1) for i in range(3)])

    # ----- pieces -------------------------------------------------------

    def _clamp_logvar(self, logvar: torch.Tensor) -> torch.Tensor:
        if self.logvar_clamp is not None:
            return torch.clamp(logvar, -self.logvar_clamp, self.logvar_clamp)
        return logvar

    def encode_with_features(self, x: torch.Tensor):
        """-> (mu, logvar, features); mu, logvar [B, latent_dim]."""
        features = self.encoder(x)
        x_enc = features[-1]
        mu = avg_pool_global(self.mu_head[0](x_enc))
        logvar = self._clamp_logvar(avg_pool_global(self.logvar_head[0](x_enc)))
        return mu, logvar, features

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mu, logvar), each [B, latent_dim].  (unet_resnet.py:242-248)"""
        mu, logvar, _ = self.encode_with_features(x)
        return mu, logvar

    def reparameterize(self, mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator], temperature: float = 1.0,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z = mu + eps * std * T.  (unet_resnet.py:191-194)

        eps comes from the noise kernel (``ops.sampling.gaussian_like``),
        whose only input is a seed, in std's type (bf16 under amp, as the
        JAX draw takes ``std.dtype``); the mu/logvar arithmetic stays
        ordinary differentiable torch.  No logvar guard beyond the head's
        clamp."""
        std = torch.exp(0.5 * logvar)
        eps = gaussian_like(generator, std.shape, std.device, eps=eps).to(std.dtype)
        return mu + eps * std * temperature

    def decode_features(self, z: torch.Tensor, features: Sequence[torch.Tensor],
                        output_hw: Optional[Tuple[int, int]] = None,
                        intermediates: Optional[Dict[str, torch.Tensor]] = None
                        ) -> torch.Tensor:
        """Decoder from a latent z [B, D] and precomputed encoder features.
        With deep supervision and an `intermediates` dict, the heads' logits
        of decoder levels 0-2 go into it as ``ds_logits_{i}``."""
        bottleneck = features[-1]
        if self.use_bottleneck:
            z_sp = broadcast_latent_spatial(z, tuple(bottleneck.shape[2:]))
            x = bn_relu(self.z_initial[0](z_sp), self.z_initial[1])
        else:
            x = bottleneck
        for i, block in enumerate(self.decoder_blocks):
            skip = features[-(i + 2)] if (i < len(features) - 1 and self.use_skip) else None
            if self.use_remat:
                x = remat.checkpoint(block, x, skip, z, policy=self.remat_policy)
            else:
                x = block(x, skip, z)
            if intermediates is not None and self.deep_supervision and i < 3:
                intermediates[f"ds_logits_{i}"] = self.ds_heads[i](x)
        logits = self.final_conv(x)
        if output_hw is not None and tuple(output_hw) != tuple(logits.shape[2:]):
            logits = resize_bilinear(logits, output_hw, align_corners=True)
        return logits

    # ----- forward ------------------------------------------------------

    def forward(self, x: torch.Tensor, sample: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                intermediates: Optional[Dict[str, torch.Tensor]] = None):
        """-> (logits, mu, logvar).  (unet_resnet.py:196-240)

        `sample=None` follows the injection strategy; sample=False is the
        deterministic z = mu forward.  A sampled z draws its noise from
        `generator`, or takes `eps` [B, latent_dim] as given.
        `intermediates` collects the deep-supervision logits
        (:meth:`decode_features`).
        """
        input_hw = tuple(x.shape[2:])
        mu, logvar, features = self.encode_with_features(x)
        do_sample = self.should_sample if sample is None else sample
        z = self.reparameterize(mu, logvar, generator, eps=eps) if do_sample else mu
        logits = self.decode_features(z, features, output_hw=input_hw,
                                      intermediates=intermediates)
        return logits, mu, logvar

    def decode(self, z: torch.Tensor, input_size: Optional[Tuple[int, int]] = None,
               probe_hw: Tuple[int, int] = (512, 512)) -> torch.Tensor:
        """Standalone decode matching unet_resnet.py:250-279: runs the encoder
        on a zero image to obtain skip shapes."""
        zeros = torch.zeros((z.shape[0], self.n_channels, *probe_hw), dtype=z.dtype,
                            device=z.device).contiguous(memory_format=torch.channels_last)
        training = self.encoder.training
        self.encoder.eval()
        try:
            features = self.encoder(zeros)
        finally:
            self.encoder.train(training)
        if not self.use_bottleneck:
            features = list(features)
            features[-1] = torch.zeros_like(features[-1])
        return self.decode_features(z, features, output_hw=input_size)


@contextlib.contextmanager
def capture_attention(model: UNetResNet) -> Iterator[Dict[str, torch.Tensor]]:
    """Collect each gate's attention map psi [B,1,H,W] during the forwards
    run inside the block, keyed ``decoder_blocks.<i>``: the counterpart of
    applying the JAX model with ``mutable=['intermediates']``."""
    maps: Dict[str, torch.Tensor] = {}
    handles = []
    for i, block in enumerate(model.decoder_blocks):
        if block.use_attention:
            def hook(_module, _inputs, output, key=f"decoder_blocks.{i}"):
                maps[key] = output
            handles.append(block.attention.psi.register_forward_hook(hook))
    try:
        yield maps
    finally:
        for h in handles:
            h.remove()


def build_model(n_channels: int = 3, n_classes: int = 1, backbone: str = "resnet34",
                latent_dim: int = 32, latent_injection: LatentInjection = "all",
                use_attention: bool = True, use_skip: bool = True,
                logvar_clamp: Optional[float] = 30.0, use_remat: bool = False,
                remat_policy: str = "full", deep_supervision: bool = False, seed: int = 0,
                device=None) -> UNetResNet:
    """A ``UNetResNet`` with PyTorch-default init drawn from `seed`, in eval
    mode and channels_last memory on `device` (CUDA unless ``"cpu"``)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNetResNet(n_channels, n_classes, backbone=backbone, latent_dim=latent_dim,
                           use_attention=use_attention, use_skip=use_skip,
                           latent_injection=latent_injection, logvar_clamp=logvar_clamp,
                           use_remat=use_remat, remat_policy=remat_policy,
                           deep_supervision=deep_supervision)
    if device.type == "cuda":
        use_fp32_numerics()
    return model.to(device=device, memory_format=torch.channels_last).eval()
