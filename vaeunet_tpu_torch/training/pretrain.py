"""In-domain self-supervised encoder pretraining.  Port of
``vaeunet_tpu/training/pretrain.py``.

The reference initializes its ResNet34 encoder from ImageNet weights
(unet_resnet.py:131-137, timm ``pretrained=True``); no weights file ships,
so two pretext tasks train the encoder on the unlabeled fundus patches:

- **masked reconstruction** (:class:`MaskedReconstructor`,
  :func:`make_pretrain_step`): random 32x32 blocks of the patch are blanked
  to its per-channel mean, the encoder sees the corrupted patch and a light
  head upsamples back to RGB; the loss is the MSE on the masked pixels plus
  0.1 times the MSE on the visible ones;
- **contrastive** (:class:`ContrastiveProjector`,
  :func:`make_contrastive_step`): SimCLR's NT-Xent over two views of each
  patch drawn by the training augmentation (``data/augment.py``, batched).

The encoder's bias-free stride-1 3x3 convs take the conv + moments kernel
in training (``models/resnet.py``).  The head's convs carry a bias and no
padding (the JAX ``Conv(w, kernel_size=3)``: ``use_bias=True``, ``padding
= 0``), so they stay cuDNN + ``BatchNorm`` as in JAX, and the BN -> ReLU
pairs take ``bn_relu`` in eval mode; the head's resizes go through
``ops/resize.py``.  The optimizer is the JAX ``optax.chain(
clip_by_global_norm(1.0), adamw(lr, weight_decay=wd))``: ``ClippedAdamW``.

``encoder_subtree`` / ``transplant_encoder`` work on state-dict prefixes:
the encoder's entries are the ``encoder.*`` keys in both the pretext
models and the VAE-UNet, so the encoder moves across by name, with JAX's
shape check and error (``:230-245``).  ``cli/pretrain.py`` writes the
subtree with ``torch.save``; ``cli/train.py --pretrained-encoder`` reads it.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vaeunet_tpu_torch.data.augment import augment_batch
from vaeunet_tpu_torch.device import resolve_device, true_div, use_fp32_numerics
from vaeunet_tpu_torch.models.resnet import ResNetEncoder
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, bn_relu
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW, TrainState
from vaeunet_tpu_torch.vae_utils import to_nchw

log = logging.getLogger(__name__)

HEAD_WIDTHS = (256, 128, 64, 32, 16)


class MaskedReconstructor(nn.Module):
    """ResNet encoder + light progressive-upsample head -> RGB recon.
    Takes and returns NCHW (channels_last)."""

    def __init__(self, n_channels: int = 3, backbone: str = "resnet34"):
        super().__init__()
        self.encoder = ResNetEncoder(n_channels, backbone=backbone)
        cin = self.encoder.feature_channels[-1]
        convs, bns = [], []
        for w in HEAD_WIDTHS:
            convs.append(Conv(cin, w, 3))
            bns.append(BatchNorm(w))
            cin = w
        self.head_convs = nn.ModuleList(convs)
        self.head_bns = nn.ModuleList(bns)
        self.head_out = Conv(cin, n_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x)[-1]                          # H/32, 512 channels
        for conv, bn in zip(self.head_convs, self.head_bns):
            h = resize_bilinear(h, (h.shape[2] * 2, h.shape[3] * 2), align_corners=False)
            h = bn_relu(conv(h), bn)
        if tuple(h.shape[2:]) != tuple(x.shape[2:]):
            h = resize_bilinear(h, tuple(x.shape[2:]), align_corners=False)
        return self.head_out(h)


class ContrastiveProjector(nn.Module):
    """ResNet encoder + global pool + 2-layer projection head (SimCLR);
    -> L2-normalized fp32 [B, proj_dim]."""

    def __init__(self, n_channels: int = 3, backbone: str = "resnet34", proj_dim: int = 128):
        super().__init__()
        self.encoder = ResNetEncoder(n_channels, backbone=backbone)
        self.proj1 = nn.Linear(self.encoder.feature_channels[-1], 256)
        self.proj2 = nn.Linear(256, proj_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x)[-1].mean(dim=(2, 3))        # [B, 512]
        # flax Dense promotes a bf16 input with fp32 parameters to fp32
        z = self.proj2(F.relu(self.proj1(h.float()))).float()
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


def build_pretrain_model(pretext: str = "masked", backbone: str = "resnet34", seed: int = 0,
                         device=None) -> nn.Module:
    """The pretext's model with PyTorch-default init drawn from `seed`, in
    channels_last memory on `device` (CUDA unless ``"cpu"``), in eval mode."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if pretext == "masked":
            model = MaskedReconstructor(backbone=backbone)
        elif pretext == "contrastive":
            model = ContrastiveProjector(backbone=backbone)
        else:
            raise ValueError(f"pretext {pretext!r}: expected 'masked' or 'contrastive'")
    if device.type == "cuda":
        use_fp32_numerics()
    return model.to(device=device, memory_format=torch.channels_last).eval()


def ntxent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.2) -> torch.Tensor:
    """Normalized-temperature cross entropy (SimCLR eq. 1) for paired
    views: z1[i] and z2[i] are positives, the other 2B - 2 rows negatives.
    Inputs L2-normalized [B, D]."""
    z = torch.cat([z1, z2], dim=0)                      # [2B, D]
    b = z1.shape[0]
    sim = (z @ z.T) / temperature
    sim = sim.masked_fill(torch.eye(2 * b, dtype=torch.bool, device=z.device), float("-inf"))
    labels = torch.cat([torch.arange(b) + b, torch.arange(b)]).to(z.device)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def make_block_mask(generator: torch.Generator, batch: int, hw: int, block: int = 32,
                    mask_ratio: float = 0.4, device=None) -> torch.Tensor:
    """[B,H,W,1] float mask: 1 where the input is blanked (to reconstruct),
    square `block`-sized cells each blanked with probability `mask_ratio`,
    drawn from `generator`."""
    g = hw // block
    u = torch.rand((batch, g, g), generator=generator, device=generator.device)
    m = (u < mask_ratio).float()
    m = m.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
    return m[..., None].to(device if device is not None else m.device)


def pretrain_optimizer(model: nn.Module, learning_rate: float,
                       weight_decay: float = 1e-5) -> ClippedAdamW:
    """The JAX ``tx``: clip to global norm 1.0, then AdamW."""
    return ClippedAdamW(model.parameters(),
                        TrainConfig(learning_rate=learning_rate, weight_decay=weight_decay,
                                    gradient_clipping=1.0))


def create_pretrain_state(model: nn.Module, learning_rate: float, weight_decay: float = 1e-5,
                          seed: int = 0) -> TrainState:
    """The pretext's state: `model`, its optimizer and a CPU generator
    seeded from `seed` for the masks and the views."""
    return TrainState(model=model, optimizer=pretrain_optimizer(model, learning_rate, weight_decay),
                      generator=torch.Generator().manual_seed(int(seed)))


def _gathered(data_images: torch.Tensor, idx) -> torch.Tensor:
    """uint8 [N,H,W,C] rows `idx` -> fp32 in [0, 1] (JAX ``jnp.take`` / 255)."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=data_images.device)
    return true_div(data_images[idx].float(), 255.0)


def make_pretrain_step(model: MaskedReconstructor, amp: bool = True, indexed: bool = False):
    """-> ``step(state, images, mask=None) -> (state, loss, masked_mse)``,
    one optimizer step on NHWC images in [0, 1]; `mask` [B,H,W,1] feeds the
    block mask, else it is drawn from ``state.generator``.  ``indexed``:
    ``step(state, data_images_u8, idx, mask=None)``, the batch gathered from
    a device cache (``data.DeviceCache.images``)."""

    def core(state: TrainState, images: torch.Tensor, mask: Optional[torch.Tensor] = None):
        model.train()
        device = next(model.parameters()).device
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        if mask is None:
            mask = make_block_mask(state.generator, images.shape[0], images.shape[1],
                                   device=device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        fill = images.mean(dim=(1, 2), keepdim=True)
        x = images * (1.0 - mask) + fill * mask
        x = to_nchw(x.to(torch.bfloat16) if amp else x)
        state.optimizer.zero_grad()
        recon = model(x).float().permute(0, 2, 3, 1)
        se = torch.square(recon - images)
        c = images.shape[-1]
        masked = (se * mask).sum() / (mask.sum() * c + 1e-8)
        visible = (se * (1 - mask)).sum() / ((1 - mask).sum() * c + 1e-8)
        loss = masked + 0.1 * visible
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), masked.detach()

    if indexed:
        def indexed_step(state, data_images, idx, mask=None):
            return core(state, _gathered(data_images, idx), mask)
        return indexed_step
    return core


def make_contrastive_step(model: ContrastiveProjector, amp: bool = True, indexed: bool = False,
                          temperature: float = 0.2):
    """-> ``step(state, images, views=None) -> (state, loss, loss)`` (the
    masked step's contract, so a training script shares the logging path).  The two
    views are the training augmentation of the batch, drawn twice from
    ``state.generator`` (``augment_batch``, on the images' device);
    `views` (v1, v2) feeds them.  ``indexed``: ``step(state,
    data_images_u8, idx, views=None)``."""

    def core(state: TrainState, images: torch.Tensor,
             views: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        model.train()
        device = next(model.parameters()).device
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        if views is None:
            dummy = torch.zeros(images.shape[:-1] + (1,), device=device)
            v1, _ = augment_batch(state.generator, images, dummy)
            v2, _ = augment_batch(state.generator, images, dummy)
        else:
            v1, v2 = (torch.as_tensor(v, dtype=torch.float32, device=device) for v in views)
        x = torch.cat([v1, v2], dim=0)
        x = to_nchw(x.to(torch.bfloat16) if amp else x)
        state.optimizer.zero_grad()
        z = model(x)
        z1, z2 = z.chunk(2, dim=0)
        loss = ntxent_loss(z1, z2, temperature)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        return state, loss, loss

    if indexed:
        def indexed_step(state, data_images, idx, views=None):
            return core(state, _gathered(data_images, idx), views)
        return indexed_step
    return core


def encoder_subtree(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The transplantable encoder state (``encoder.*`` entries, parameters
    and BN statistics) of a pretext model's state dict, on the host."""
    return {k: v.detach().cpu() for k, v in state_dict.items() if k.startswith("encoder.")}


def transplant_encoder(state_dict: Mapping[str, torch.Tensor],
                       encoder_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state_dict` (a VAE-UNet's, or any model's with an ``encoder``) with
    its encoder entries replaced by `encoder_state`'s; raises ValueError
    when the names or shapes differ (a backbone mismatch)."""
    src = {k: tuple(v.shape) for k, v in encoder_state.items() if k.startswith("encoder.")}
    dst = {k: tuple(v.shape) for k, v in state_dict.items() if k.startswith("encoder.")}
    if src != dst:
        raise ValueError("pretrained encoder param shapes do not match model "
                         f"(backbone mismatch?): {src} vs {dst}")
    out = dict(state_dict)
    out.update({k: encoder_state[k] for k in dst})
    return out
