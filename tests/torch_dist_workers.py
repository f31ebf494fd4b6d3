"""Rank bodies of the port's multi-process CPU tests.

``vaeunet_tpu_torch.parallel.launch`` runs each function here on fresh
gloo ranks.  This module imports torch and the port only (no jax, and
nothing of the JAX package), so the spawned ranks start fast and never
load jax under the test session's 8-device ``XLA_FLAGS``; the JAX
references are computed in the test process.  Pytest does not collect
it (no ``test_`` prefix).  Each body bundles several checks, so that a
test file spawns few times; every result comes back on the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from vaeunet_tpu_torch.ops import collectives
from vaeunet_tpu_torch.parallel.dp import make_dp_eval_step, make_dp_train_step
from vaeunet_tpu_torch.parallel.inference import ensemble_sample_parallel, predict_tiled_sharded
from vaeunet_tpu_torch.parallel.mesh import make_mesh, rank_rows, shard_batch
from vaeunet_tpu_torch.parallel.tp import shard_state
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import TrainState, create_train_state, make_optimizer
from vaeunet_tpu_torch.training.step import make_train_step


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _state(cfg_kwargs: dict, sd: dict, device="cpu", seed: int = 0, model=None):
    """A fresh state of `sd`'s weights; `model` (of an earlier state) is
    reused, its weights reloaded, instead of building a new one."""
    config = TrainConfig(**cfg_kwargs)
    if model is None:
        state = create_train_state(config, seed=seed, device=device)
    else:
        state = TrainState(model=model, optimizer=make_optimizer(model, config),
                           generator=torch.Generator().manual_seed(seed + 1))
    if sd is not None:
        state.model.load_state_dict(sd)
    return config, state


def _grads(model) -> Dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}


# ----- mesh and collectives ------------------------------------------------

def collective_checks(ctx, n: int) -> Dict[str, Any]:
    """all_reduce_sum, gather and copy_to_group with their gradients."""
    x = (torch.arange(n, dtype=torch.float32) + 10 * ctx.rank).reshape(1, n).requires_grad_()
    s = collectives.all_reduce_sum(x, ctx.data)
    g = collectives.gather(x, 0, ctx.data)
    c = collectives.copy_to_group(x, ctx.data)
    weights = torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape)
    (2 * s.sum() + (g * weights).sum() + 3 * c.sum()).backward()
    y = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(ctx.rank))
    y = y.contiguous(memory_format=torch.channels_last)
    gy = collectives.gather(y, 1, ctx.data)
    yb = collectives.gather(y.to(torch.bfloat16), 0, ctx.data)
    return {"rank": ctx.rank, "sum": _host(s), "gather": _host(g), "grad": _host(x.grad),
            "y": y, "gy": gy, "gy_channels_last": gy.is_contiguous(
                memory_format=torch.channels_last),
            "yb": yb, "shape": ctx.shape, "data_rank": ctx.data_rank,
            "model_rank": ctx.model_rank, "backend": ctx.backend}


def failing_rank(ctx) -> None:
    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)


def sleeping_rank(ctx, seconds: float) -> None:
    time.sleep(seconds)


def mesh_refusals(ctx) -> Dict[str, str]:
    """make_mesh's refusals, as messages, and its device with none given
    and with the CPU asked for."""
    out = {}
    for key, kw in (("more", dict(num_devices=ctx.world_size + 1)),
                    ("fewer", dict(num_devices=1)),
                    ("axis", dict(model_axis=3))):
        try:
            make_mesh(**kw)
            out[key] = ""
        except ValueError as e:
            out[key] = str(e)
    try:                                               # no device given: the card's
        out["default"] = str(make_mesh().device)
    except RuntimeError as e:
        out["default"] = str(e)
    out["cpu"] = str(make_mesh(device="cpu").device)
    return out


# ----- data parallelism ----------------------------------------------------

def dp_steps(ctx, cfg_kwargs: dict, sd: dict, images: np.ndarray, masks: np.ndarray,
             eps: np.ndarray, beta: float, eval_batch: tuple) -> Dict[str, Any]:
    """The global-batch step (gradients, then a whole step), the same with
    the augmentation and the noise drawn, the per-device step, and the
    eval step, each from the same weights.  `eps` is the global noise
    [accum, micro, D]; each step gets this rank's rows."""
    out: Dict[str, Any] = {"rank": ctx.rank}
    accum = max(1, cfg_kwargs.get("gradient_accumulation_steps", 1))
    micro = eps.shape[1] // ctx.n_data
    eps_r = torch.from_numpy(eps[:, ctx.data_rank * micro:(ctx.data_rank + 1) * micro])
    im_r, mk_r = shard_batch(ctx, images, masks, accum=accum)

    config, state = _state(cfg_kwargs, sd, ctx.device)
    model = state.model
    aux = make_dp_train_step(config, ctx, state.model).compute_gradients(
        state, im_r, mk_r, beta, eps=eps_r)
    out["global_grads"] = _grads(state.model)
    out["global_grad_aux"] = _host(aux)

    config, state = _state(cfg_kwargs, sd, ctx.device, model=model)
    state, aux = make_dp_train_step(config, ctx, state.model)(state, im_r, mk_r, beta, eps=eps_r)
    out["global_aux"], out["global_state"] = _host(aux), _host(state.model.state_dict())

    config, state = _state(cfg_kwargs, sd, ctx.device, seed=5, model=model)
    state, aux = make_dp_train_step(config, ctx, state.model, augment=True)(
        state, im_r, mk_r, beta)
    out["augment_aux"], out["augment_state"] = _host(aux), _host(state.model.state_dict())

    rows = rank_rows(len(images), ctx.n_data, ctx.data_rank)
    config, state = _state(cfg_kwargs, sd, ctx.device, model=model)
    state, aux = make_dp_train_step(config, ctx, state.model, explicit=True)(
        state, torch.from_numpy(images[rows]), torch.from_numpy(masks[rows]), beta,
        eps=torch.from_numpy(eps.reshape(-1, eps.shape[-1])[rows][None]))
    out["explicit_aux"], out["explicit_state"] = _host(aux), _host(state.model.state_dict())

    e_images, e_masks, e_eps, e_valid = eval_batch
    config, state = _state(cfg_kwargs, sd, ctx.device, model=model)
    metrics, logits = make_dp_eval_step(config, ctx, state.model)(
        e_images, e_masks, eps=e_eps, valid=e_valid)
    out["eval_metrics"], out["eval_logits"] = _host(metrics), _host(logits)
    return out


def dp_accum_step(ctx, cfg_kwargs: dict, sd: dict, images: np.ndarray, masks: np.ndarray,
                  eps: np.ndarray, beta: float) -> Dict[str, Any]:
    """The global-batch step with gradient accumulation: each rank holds
    its share of every microbatch (``shard_batch(..., accum=)``) and its
    rows of each microbatch's noise."""
    accum = cfg_kwargs["gradient_accumulation_steps"]
    micro = eps.shape[1] // ctx.n_data
    config, state = _state(cfg_kwargs, sd, ctx.device)
    im_r, mk_r = shard_batch(ctx, images, masks, accum=accum)
    eps_r = torch.from_numpy(eps[:, ctx.data_rank * micro:(ctx.data_rank + 1) * micro])
    state, aux = make_dp_train_step(config, ctx, state.model)(state, im_r, mk_r, beta, eps=eps_r)
    return {"aux": _host(aux), "state": _host(state.model.state_dict())}


def dp_world_one(ctx, cfg_kwargs: dict, sd: dict, images: np.ndarray, masks: np.ndarray,
                 beta: float) -> Dict[str, bool]:
    """On one rank the global-batch step is the single-process step, bit
    for bit, with the augmentation and the noise drawn (on a card with
    cuDNN's deterministic algorithms: its fp32 backward is otherwise not
    bit-exact from run to run)."""
    torch.backends.cudnn.deterministic = True
    out = {}
    results = []
    for dp in (True, False):
        config, state = _state(cfg_kwargs, sd, ctx.device)
        step = (make_dp_train_step(config, ctx, state.model, augment=True) if dp
                else make_train_step(config, state.model, augment=True))
        for _ in range(2):
            state, aux = step(state, images, masks, beta)
        results.append((_host(aux), _host(state.model.state_dict()), state.generator.get_state()))
    (a1, s1, g1), (a2, s2, g2) = results
    out["aux"] = all(torch.equal(a1[k], a2[k]) for k in a1)
    out["state"] = all(torch.equal(s1[k], s2[k]) for k in s1)
    out["generator"] = torch.equal(g1, g2)
    return out


# ----- tensor parallelism --------------------------------------------------

def tp_steps(ctx, cfg_kwargs: dict, sd: dict, images: np.ndarray, masks: np.ndarray,
             eps: np.ndarray, beta: float, min_channels: int) -> Dict[str, Any]:
    """The step with the wide convs sharded over 'model': the eval forward,
    the whole gradient (the sharded parts gathered) and the clip's norm,
    then a whole step's aux and parameters (cuDNN's deterministic
    algorithms on a card, so that the model ranks' replicated work agrees
    bit for bit)."""
    torch.backends.cudnn.deterministic = True
    return {"rank": ctx.rank, **_tp_run(ctx, cfg_kwargs, sd, images, masks, eps, beta,
                                       min_channels, dict(sample=False))}


def tp_unet_and_save_convs(ctx, unet_kwargs: dict, unet_sd: dict, remat_kwargs: dict,
                           remat_sd: dict, images: np.ndarray, masks: np.ndarray,
                           eps: np.ndarray, beta: float, min_unet: int,
                           min_remat: int) -> Dict[str, Any]:
    """What :func:`tp_steps` returns, for the plain UNet (its transposed
    convs row-parallel; no latent, so no noise) under "unet", and for a
    VAE-UNet with remat 'save_convs' under "remat"."""
    torch.backends.cudnn.deterministic = True
    return {"rank": ctx.rank,
            "unet": _tp_run(ctx, unet_kwargs, unet_sd, images, masks, None, beta, min_unet, {}),
            "remat": _tp_run(ctx, remat_kwargs, remat_sd, images, masks, eps, beta, min_remat,
                             dict(sample=False))}


def _tp_run(ctx, cfg_kwargs: dict, sd: dict, images: np.ndarray, masks: np.ndarray, eps,
            beta: float, min_channels: int, eval_kwargs: dict) -> Dict[str, Any]:
    eps = None if eps is None else torch.from_numpy(eps)
    out: Dict[str, Any] = {}
    config, state = _state(cfg_kwargs, sd, ctx.device)
    model = state.model
    names = shard_state(state, config, ctx, min_channels)
    out["sharded"] = names
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(images).to(ctx.device).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        logits = model(x, **eval_kwargs)
        out["eval_logits"] = _host(logits[0] if isinstance(logits, tuple) else logits)
    step = make_train_step(config, model)
    step.compute_gradients(state, images, masks, beta, eps=eps)
    grads = {n: (collectives.gather(p.grad, 0, ctx.model) if n in names else p.grad)
             for n, p in model.named_parameters()}
    out["grads"] = _host(grads)
    out["full_norm"] = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
    out["clip_norm"] = float(state.optimizer.clip_())

    config, state = _state(cfg_kwargs, sd, ctx.device)
    model = state.model
    shard_state(state, config, ctx, min_channels)
    state, aux = make_train_step(config, model)(state, images, masks, beta, eps=eps)
    params = dict(model.named_parameters())
    full = {k: (collectives.gather(params[k].detach(), 0, ctx.model) if k in names else v)
            for k, v in model.state_dict().items()}
    out["aux"], out["state"] = _host(aux), _host(full)
    return out


# ----- inference -----------------------------------------------------------

def inference_checks(ctx, model_kwargs: dict, sd: dict, image: np.ndarray, zs: np.ndarray,
                     tile_image: np.ndarray, z: np.ndarray, patch: int) -> Dict[str, Any]:
    from vaeunet_tpu_torch.models.vae_unet import build_model

    model = build_model(device=ctx.device, **model_kwargs)
    model.load_state_dict(sd)
    out: Dict[str, Any] = {"rank": ctx.rank}
    out["ensemble"] = ensemble_sample_parallel(model, image, zs, ctx)
    out["tiled"] = predict_tiled_sharded(model, tile_image, z, ctx, patch_size=patch,
                                         batch_size=2)
    try:
        ensemble_sample_parallel(model, image, zs[:3], ctx)
        out["refusal"] = ""
    except ValueError as e:
        out["refusal"] = str(e)
    return _host(out)
