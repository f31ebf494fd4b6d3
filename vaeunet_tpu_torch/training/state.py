"""Train state: model + optimizer + noise generator + step count.  Port of
``vaeunet_tpu/training/state.py``.

The JAX package keeps params, BN statistics, optimizer state and PRNG key
in one immutable pytree; here the model holds its parameters and running
statistics, the optimizer its moments, and a ``torch.Generator`` the
seed stream of the latent noise and of the augmentation, all updated in
place by the train step.

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm(1.0),
adamw(...))`` (``state.py:41-49``): the gradients are scaled by
max_norm / ||g|| only when ||g|| >= max_norm, as optax writes it (``t /
||g|| * max_norm``; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm and would differ), then ``torch.optim.AdamW`` with betas (0.9, 0.999),
eps 1e-8 and the config's weight decay over every parameter, as optax's
unmasked ``adamw`` decays every leaf.  The learning rate lives in the
param groups, so a host-side schedule changes it between steps.
``ClippedAdamW.state_dict`` / ``load_state_dict`` carry AdamW's state and
the clip norm, so a restored optimizer takes the step an unbroken one
would.

:func:`build_model` builds the config's model (``model_type`` 'resnet':
the VAE-UNet; 'basic': the plain UNet) and honours or refuses each of its
architecture fields: ``bilinear`` (the plain UNet's), ``use_remat`` (both),
``remat_policy`` (the VAE-UNet's; the plain UNet's remat is always
'full', as in the JAX package, so the port refuses 'save_convs' there),
``deep_supervision`` (the VAE-UNet's; the JAX step ignores it for the
plain UNet, the port refuses it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from vaeunet_tpu_torch.compat.jax_weights import load_jax_variables
from vaeunet_tpu_torch.device import resolve_device
from vaeunet_tpu_torch.models.unet import UNet, build_unet
from vaeunet_tpu_torch.models.vae_unet import UNetResNet, build_model as build_vae_unet
from vaeunet_tpu_torch.ops import remat
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.utils.profiling import span


class ClippedAdamW:
    """Clip by global norm (optax's formula), then AdamW."""

    def __init__(self, params: List[torch.nn.Parameter], config: TrainConfig):
        self.params = list(params)
        self.max_norm = float(config.gradient_clipping)
        self.adamw = torch.optim.AdamW(self.params, lr=config.learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=config.weight_decay)

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def clip_(self) -> torch.Tensor:
        """Scale the gradients in place to global norm <= max_norm; -> the
        norm before clipping.  No host sync: the choice is a ``where``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        return norm

    def step(self) -> torch.Tensor:
        """Clip, then AdamW (spans ``train.clip``, ``train.adamw``)."""
        with span("train.clip"):
            norm = self.clip_()
        with span("train.adamw"):
            self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "max_norm": self.max_norm}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.max_norm = float(state["max_norm"])
        self.adamw.load_state_dict(state["adamw"])


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: ClippedAdamW
    generator: torch.Generator
    step: int = 0


def make_optimizer(model: torch.nn.Module, config: TrainConfig) -> ClippedAdamW:
    return ClippedAdamW(model.parameters(), config)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def build_model(config: TrainConfig, seed: int = 0,
                device=None) -> Union[UNetResNet, UNet]:
    """The config's model with PyTorch-default init from `seed`, in
    channels_last memory on `device` (CUDA unless ``"cpu"``), in eval mode
    (train.py:680-695).  Raises for a field the model cannot honour."""
    remat.check_policy(config.remat_policy)
    if config.model_type == "basic":
        if config.deep_supervision:
            raise ValueError("deep_supervision needs model_type='resnet': the plain UNet has "
                             "no auxiliary heads")
        if config.use_remat and config.remat_policy != "full":
            raise ValueError(f"remat_policy {config.remat_policy!r} needs model_type='resnet': "
                             "the plain UNet rematerializes its stages in full")
        return build_unet(n_channels=config.n_channels, n_classes=config.n_classes,
                          bilinear=config.bilinear, use_remat=config.use_remat,
                          seed=seed, device=device)
    if config.model_type != "resnet":
        raise ValueError(f"model_type {config.model_type!r}: expected 'resnet' or 'basic'")
    if config.bilinear:
        raise ValueError("bilinear=True selects the plain UNet's upsampling; the VAE-UNet's "
                         "decoder is always bilinear (use model_type='basic')")
    return build_vae_unet(n_channels=config.n_channels, n_classes=config.n_classes,
                          backbone=config.backbone, latent_dim=config.latent_dim,
                          latent_injection=config.latent_injection,
                          use_attention=config.use_attention, use_skip=config.use_skip,
                          use_remat=config.use_remat, remat_policy=config.remat_policy,
                          deep_supervision=config.deep_supervision, seed=seed, device=device)


def create_train_state(config: TrainConfig, seed: int = 0,
                       variables: Optional[Mapping[str, Any]] = None,
                       device=None) -> TrainState:
    """A fresh state: the model from `seed` (or from converted flax
    `variables`, a ``{'params', 'batch_stats'}`` tree), its optimizer, and
    a CPU generator seeded from `seed` that draws the train step's random
    numbers: the latent noise's seeds and, with ``augment=True``, the
    augmentation's flags, parameters and noise seed."""
    device = resolve_device(device)
    model = build_model(config, seed=seed, device=device)
    if variables is not None:
        load_jax_variables(model, variables)      # copies into the device tensors
    generator = torch.Generator().manual_seed(int(seed) + 1)
    return TrainState(model=model, optimizer=make_optimizer(model, config), generator=generator)
