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
would.  On CUDA parameters the step is two launches of
``ops/pallas/clip_adamw.py``'s kernels, which compute what ``clip_`` and
torch's AdamW compute there (the norm's sums in another order) on torch's
AdamW state, made and counted here as torch makes and counts it, so a
checkpoint of either path resumes on the other; CPU parameters take
``clip_`` and ``self.adamw.step()``, the plain version.

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
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vaeunet_tpu_torch.compat.jax_weights import load_jax_variables
from vaeunet_tpu_torch.device import resolve_device
from vaeunet_tpu_torch.models.unet import UNet, build_unet
from vaeunet_tpu_torch.models.vae_unet import UNetResNet, build_model as build_vae_unet
from vaeunet_tpu_torch.ops import remat
from vaeunet_tpu_torch.ops.pallas import clip_adamw
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.utils.profiling import span


def _scalar_dtype() -> torch.dtype:
    """The dtype of torch's AdamW ``step`` (``optimizer._get_scalar_dtype``)."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


class _KernelState:
    """What the kernels' steps keep between steps for one set of parameters
    with gradients: the launches' plan, and a mirror of the AdamW ``step``
    counts of its tensors for the bias corrections, with each ``step``
    tensor's memory to write the count back into.  AdamW's state is made
    as torch's ``_init_group`` makes it: ``step`` a CPU scalar of its own,
    the moments zeros in the parameter's layout."""

    def __init__(self, adamw: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                 active: List[int]):
        ps = [params[i] for i in active]
        states = []
        for p in ps:
            state = adamw.state[p]
            if len(state) == 0:
                state["step"] = torch.tensor(0.0, dtype=_scalar_dtype())
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif state["step"].device.type != "cpu":
                raise ValueError(f"clip_adamw: a step count on {state['step'].device}, not the "
                                 "CPU")
            states.append(state)
        self.plan = clip_adamw.Plan(ps, [s["exp_avg"] for s in states],
                                    [s["exp_avg_sq"] for s in states])
        self.active = active
        self.param_ptrs = [p.data_ptr() for p in ps]
        self.step_views = [s["step"].numpy() for s in states]
        self.steps = np.array([float(s["step"]) for s in states])

    def fits(self, params: Sequence[torch.Tensor], active: List[int]) -> bool:
        return active == self.active and [params[i].data_ptr() for i in active] == self.param_ptrs

    def count_step(self, group: dict) -> None:
        """Every tensor's step + 1, in its ``step`` tensor too, and the bias
        corrections at it into the plan."""
        self.steps += 1
        for view, s in zip(self.step_views, self.steps):
            view[...] = s
        beta1, beta2 = group["betas"]
        self.plan.set_scalars(self.steps, beta1, beta2, float(group["lr"]))


class ClippedAdamW:
    """Clip by global norm (optax's formula), then AdamW."""

    def __init__(self, params: List[torch.nn.Parameter], config: TrainConfig):
        self.params = list(params)
        self.max_norm = float(config.gradient_clipping)
        self.adamw = torch.optim.AdamW(self.params, lr=config.learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=config.weight_decay)
        # the kernels' state, in a box the hooks clear (without holding this
        # object) when torch's step or a load changes the counts it mirrors
        box: List[Optional[_KernelState]] = [None]
        self._kernel_box = box

        def forget(*_args, **_kwargs):
            box[0] = None

        self.adamw.register_step_post_hook(forget)
        self.adamw.register_load_state_dict_post_hook(forget)

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def global_norm(self) -> torch.Tensor:
        """||g|| over the gradients, as a device scalar."""
        grads = [p.grad for p in self.params if p.grad is not None]
        return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))

    def clip_(self) -> torch.Tensor:
        """Scale the gradients in place to global norm <= max_norm; -> the
        norm before clipping.  No host sync: the choice is a ``where``."""
        norm = self.global_norm()
        keep = norm < self.max_norm
        for p in self.params:
            if p.grad is not None:
                p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * self.max_norm))
        return norm

    def step(self) -> torch.Tensor:
        """Clip, then AdamW -> the norm before clipping: CUDA parameters
        take :meth:`kernel_step`, others :meth:`plain_step`."""
        if not self.params or self.params[0].device.type != "cuda":
            return self.plain_step()
        return self.kernel_step()

    def kernel_step(self) -> torch.Tensor:
        """The step on the kernels (spans ``train.clip``: the gradients'
        table and :meth:`kernel_norm`; ``train.adamw``: the step counts and
        the update launch) -> the norm before clipping."""
        with span("train.clip"):
            state = self.kernel_state()
            norm = self.kernel_norm(state.plan)
        with span("train.adamw"):
            group = self.adamw.param_groups[0]
            state.count_step(group)
            clip_adamw.update(state.plan, norm, group, self.max_norm)
        return norm

    def kernel_state(self) -> _KernelState:
        """The kernels' state for the parameters that have gradients, made
        anew when they or a parameter's storage changed, with this step's
        gradients in its table."""
        if len(self.adamw.param_groups) != 1:
            raise ValueError("clip_adamw takes one param group")
        clip_adamw.check_group(self.adamw.param_groups[0])
        grads = [p.grad for p in self.params]
        active = [i for i, g in enumerate(grads) if g is not None]
        state = self._kernel_box[0]
        if state is None or not state.fits(self.params, active):
            state = self._kernel_box[0] = _KernelState(self.adamw, self.params, active)
        state.plan.set_grads([grads[i] for i in active])
        return state

    def kernel_norm(self, plan: clip_adamw.Plan) -> torch.Tensor:
        """The norm the update clips by: the norm kernel's."""
        return clip_adamw.norm(plan)

    def plain_step(self) -> torch.Tensor:
        """:meth:`clip_`, then torch's AdamW, under the same spans."""
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
