"""The train and eval steps.  Port of ``vaeunet_tpu/training/step.py``
(``_forward_loss``, ``make_train_step``, ``make_eval_step``).

- forward (BN batch statistics updated) -> Dice + BCE (or the MA rule) +
  beta * KL with free bits, logits cast to fp32 before the loss;
- gradient accumulation over ``gradient_accumulation_steps`` microbatches:
  the mean of the microbatch gradients, the BN running statistics threaded
  through the microbatches in turn, one latent draw per microbatch (the JAX
  ``lax.scan``, here a Python loop);
- clip to global norm 1.0 and AdamW (``training/state.py``);
- ``config.amp``: the images are cast to bf16 and every layer computes in
  its input's type (``ops/layers.py``), as the JAX step casts them
  (``step.py:39-40``); parameters, BN statistics and the loss stay fp32.
  No ``torch.autocast``.

- the plain UNet (``model_type='basic'``) trains through the same step:
  no latent, kl = 0, mu and logvar fp32 zeros [B, 1] (``step.py:43-51``);
- ``deep_supervision`` (VAE-UNet only, as JAX's ``ds = is_vae and ...``):
  the heads of decoder levels 2, 1, 0 add their loss against the masks
  resized to their size (``align_corners=False``, the resize kernel) with
  weights 1/2, 1/4, 1/8, and the sum is divided by the total weight
  (``step.py:54-67``);
- ``debug_nans`` (``step.py:117-120``): the forward and backward run under
  ``torch.autograd.detect_anomaly(check_nan=True)`` and a non-finite loss
  raises ``FloatingPointError``; without the flag neither runs, so the step
  makes no host sync for it.

Images and masks come NHWC, as the JAX step takes them ([B, H, W, 3] and
[B, H, W, n_classes]); the model sees NCHW in channels_last memory, a free
view of the same bytes.  beta is a plain float.

``augment=True`` runs the on-device policy (``data/augment.py``) on the
whole effective batch inside the step, before the forward, its flags and
noise drawn from ``state.generator`` ahead of the latent draws
(``step.py:122-131``).  ``indexed=True`` takes the batch from a device cache
instead of the host: ``step(state, data_images, data_masks, idx, beta)``,
the batch gathered by ``gather`` (a cache's ``make_gather()``; default the
patch layout's ``gather_batch_device``), as ``step.py:183-194,276-287``.

``multi_temp_training_step`` (``step.py:201-229``) blends the standard loss
with the loss of the mean tempered predictions.

``group`` (a ``torch.distributed`` process group over the data axis) is
the counterpart of the JAX step's ``axis_name`` (``step.py:124-126,
168-174``), the per-device step of ``shard_map``: each rank takes its own
rows and its own noise (a per-step generator seeded by one draw of the
state's generator folded with the rank), normalizes with its rows' BN
statistics, and the gradients are averaged over the group in one
flattened bucket before the clip and AdamW; loss, recon_loss and kl_loss
are averaged, mu and logvar gathered, the running statistics averaged.
With ``global_batch`` as well, the step is the single-device step of the
global batch, the pjit step of ``parallel/dp.py``: BN moments and the
loss run over every rank's rows, the random draws are the global batch's
(this rank's rows of them), and the averaged gradient is the global one.
No group: the single-process step, unchanged.

The train step records its phases as spans (``utils/profiling.py``; only
while a ``torch.profiler`` session runs): ``train.step`` around the whole
step, inside it ``train.gather`` (the indexed step's batch),
``train.forward`` and ``train.backward`` once a microbatch, then
``train.clip`` and ``train.adamw`` (``training/state.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from vaeunet_tpu_torch.data.augment import (
    apply_policy,
    augment_batch,
    draw_params,
    params_to,
)
from vaeunet_tpu_torch.data.device_cache import gather_batch_device
from vaeunet_tpu_torch.device import as_image, host_to_device
from vaeunet_tpu_torch.losses import kl_with_free_bits, make_criterion
from vaeunet_tpu_torch.metrics import metrics_from_sums, pooled_sums
from vaeunet_tpu_torch.models.vae_unet import UNetResNet
from vaeunet_tpu_torch.ops import collectives
from vaeunet_tpu_torch.ops.layers import BatchNorm
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.ops.sampling import fold_in, gaussian_like, seed_from_generator
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import TrainState
from vaeunet_tpu_torch.utils.profiling import span
from vaeunet_tpu_torch.vae_utils import mean_tempered_logits


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_model_layout(images, device: torch.device) -> torch.Tensor:
    """NHWC images (numpy or torch) -> NCHW channels_last fp32 on `device`."""
    x = as_image(images, device).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def forward_loss(model: torch.nn.Module, criterion: Callable, config: TrainConfig,
                 images: torch.Tensor, masks: torch.Tensor, beta: float,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None, group=None) -> Tuple[torch.Tensor, Dict]:
    """One training forward (``step.py:35-74``): images NCHW channels_last
    fp32, masks NHWC fp32 -> (loss, aux).  ``group``: the loss of the
    global batch, from the ranks' logits, masks, latents and
    deep-supervision logits gathered along the batch in rank order (every
    rank computes it; aux mu and logvar are then the global rows)."""
    if config.amp:
        images = images.to(torch.bfloat16)
    is_vae = isinstance(model, UNetResNet)
    ds = is_vae and config.deep_supervision
    inter: Optional[Dict[str, torch.Tensor]] = {} if ds else None
    if is_vae:
        logits, mu, logvar = model(images, generator=generator, eps=eps, intermediates=inter)
    else:
        logits = model(images)
        mu = logvar = torch.zeros((images.shape[0], 1), device=images.device)
    logits = logits.float().permute(0, 2, 3, 1)
    if group is not None:
        logits = collectives.gather(logits, 0, group)
        masks = collectives.gather(masks, 0, group)
        mu, logvar = collectives.gather(mu, 0, group), collectives.gather(logvar, 0, group)
    recon = criterion(logits, masks)
    if ds:
        masks_cl = masks.permute(0, 3, 1, 2)          # channels_last NCHW, the same bytes
        w, total_w = 1.0, 1.0
        for i in (2, 1, 0):                           # 1/4 -> 1/16 resolution
            aux = inter[f"ds_logits_{i}"].float()
            if group is not None:
                aux = collectives.gather(aux, 0, group)
            w *= 0.5
            soft = resize_bilinear(masks_cl, tuple(aux.shape[2:]), align_corners=False)
            recon = recon + w * criterion(aux.permute(0, 2, 3, 1), soft.permute(0, 2, 3, 1))
            total_w += w
        recon = recon / total_w
    if is_vae:
        kl = kl_with_free_bits(mu, logvar, free_bits=config.free_bits,
                               clamp_leak=config.kl_clamp_leak)
    else:
        kl = torch.zeros((), device=images.device)
    loss = recon + beta * kl
    aux = {"loss": loss, "recon_loss": recon, "kl_loss": kl,
           "mu": mu.float(), "logvar": logvar.float()}
    return loss, aux


def _index_tensor(idx, device: torch.device) -> torch.Tensor:
    return host_to_device(torch.as_tensor(idx, dtype=torch.int64), device)


@contextlib.contextmanager
def batch_norm_group(model: torch.nn.Module, group) -> Iterator[None]:
    """Every :class:`BatchNorm` of `model` normalizes over `group`'s ranks
    while the block runs (None: a no-op)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)] if group is not None else []
    for bn in bns:
        bn.group = group
    try:
        yield
    finally:
        for bn in bns:
            bn.group = None


def average_over(tensors: List[torch.Tensor], group) -> None:
    """The mean of each tensor over `group`'s ranks, in place: one
    flattened bucket, one all-reduce."""
    if not tensors:
        return
    with torch.no_grad():
        flat = collectives.all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
        flat.div_(dist.get_world_size(group))
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def _augment_rows(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  world: int, rank: int, accum: int):
    """``augment_batch`` of the global batch, applied to this rank's rows:
    the parameters and the noise are drawn for all ``world * B`` rows, as
    the single-device step draws them, and this rank's rows kept."""
    n = images.shape[0] * world
    rows = torch.from_numpy(collectives.rank_rows(n, world, rank, accum))
    params = {k: v[rows] for k, v in draw_params(generator, n).items()}
    eps = gaussian_like(generator, (n, *images.shape[1:]), images.device)
    return apply_policy(params_to(params, images.device), images, masks,
                        eps[rows.to(images.device)])


def make_train_step(config: TrainConfig, model: torch.nn.Module,
                    criterion: Optional[Callable] = None, augment: bool = False,
                    indexed: bool = False, gather: Optional[Callable] = None,
                    group=None, global_batch: bool = False):
    """-> ``step(state, images, masks, beta, eps=None) -> (state, aux)``,
    one optimizer step on `model` (the state's model), in place.
    ``images`` is [accum * micro, H, W, C]; ``eps``, if given, is the
    latent noise [accum, micro, latent_dim], otherwise each microbatch
    draws its own from ``state.generator``.  aux
    holds ``loss``, ``recon_loss``, ``kl_loss`` (means over microbatches)
    and ``mu``, ``logvar`` [B, latent_dim], all detached.

    ``augment``: the images and masks go through ``augment_batch`` on the
    device first.  ``indexed``: ``step(state, data_images, data_masks, idx,
    beta, eps=None)``, the batch ``gather(data_images, data_masks, idx)``
    from a device cache (host indices in one copy).

    ``step.compute_gradients(state, images, masks, beta, eps=None) ->
    aux`` (the non-indexed form) stops before the clip: the parameters'
    ``.grad`` then hold the mean of the microbatch gradients.

    ``group`` (with ``global_batch`` or not; module docstring): ``images``,
    ``masks`` and ``eps`` are this rank's rows (``parallel/mesh.py``'s
    ``shard_batch``; under ``global_batch`` with accumulation, its share
    of each microbatch in turn), and every rank of the group must call the
    step.
    """
    criterion = criterion or make_criterion(config.lesion_type, config.loss)
    accum = max(1, config.gradient_accumulation_steps)
    is_vae = isinstance(model, UNetResNet)
    if global_batch and group is None:
        raise ValueError("global_batch needs the data-parallel group")
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    # the group the BNs and the loss reduce over: none on one rank, where
    # the global batch is this rank's
    loss_group = group if global_batch and world > 1 else None
    if config.deep_supervision and not (is_vae and model.deep_supervision):
        raise ValueError("deep_supervision needs a VAE-UNet built with its heads "
                         "(training.build_model)")

    def anomaly_mode():
        if config.debug_nans:
            return torch.autograd.detect_anomaly(check_nan=True)
        return contextlib.nullcontext()

    def compute_gradients(state: TrainState, images, masks, beta: float,
                          eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.train()
        device = _device(model)
        images = as_image(images, device)
        m = torch.as_tensor(masks, dtype=torch.float32, device=device)
        generator = state.generator
        if group is not None and not global_batch:
            # this rank's stream: the JAX step folds the axis index into its key
            generator = torch.Generator().manual_seed(
                fold_in(seed_from_generator(state.generator), rank))
        if augment:
            if global_batch:
                images, m = _augment_rows(generator, images, m, world, rank, accum)
            else:
                images, m = augment_batch(generator, images, m)
        x = to_model_layout(images, device)
        b = x.shape[0]
        micro = b // accum
        if micro * accum != b:
            raise ValueError(f"batch {b} not divisible by accumulation {accum}")
        if eps is not None:
            if not is_vae:
                raise ValueError("eps feeds the VAE-UNet's latent; this model has none")
            eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
            if tuple(eps.shape[:2]) != (accum, micro):
                raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                                 f"[{accum}, {micro}, latent_dim]")
        state.optimizer.zero_grad()
        auxes = []
        with batch_norm_group(model, loss_group):
            for i in range(accum):
                sl = slice(i * micro, (i + 1) * micro)
                eps_i = None if eps is None else eps[i]
                if eps_i is None and global_batch and is_vae and model.should_sample:
                    # the global microbatch's draw, this rank's rows of it
                    eps_i = gaussian_like(generator, (micro * world, model.latent_dim),
                                          device)[rank * micro:(rank + 1) * micro]
                with anomaly_mode():
                    with span("train.forward"):
                        loss, aux = forward_loss(model, criterion, config, x[sl], m[sl], beta,
                                                 generator=generator, eps=eps_i,
                                                 group=loss_group)
                    if config.debug_nans and not bool(torch.isfinite(loss)):
                        raise FloatingPointError(
                            f"non-finite loss {loss.item()} in microbatch {i}")
                    with span("train.backward"):
                        loss.backward()
                auxes.append({k: v.detach() for k, v in aux.items()})
        if accum > 1:
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
        out = {k: torch.stack([a[k] for a in auxes]).mean()
               for k in ("loss", "recon_loss", "kl_loss")}
        out["mu"] = torch.cat([a["mu"] for a in auxes])
        out["logvar"] = torch.cat([a["logvar"] for a in auxes])
        if group is not None:
            average_over([p.grad for p in model.parameters() if p.grad is not None], group)
            if not global_batch:       # pmean of the per-rank results (step.py:168-174)
                for k in ("loss", "recon_loss", "kl_loss"):
                    out[k] = collectives.all_reduce_sum(out[k], group) / world
                out["mu"] = collectives.gather(out["mu"], 0, group)
                out["logvar"] = collectives.gather(out["logvar"], 0, group)
                average_over([b for mod in model.modules() if isinstance(mod, BatchNorm)
                              for b in (mod.running_mean, mod.running_var)], group)
        return out

    def update(state: TrainState, images, masks, beta: float,
               eps: Optional[torch.Tensor] = None):
        aux = compute_gradients(state, images, masks, beta, eps)
        state.optimizer.step()
        state.step += 1
        return state, aux

    def step(state: TrainState, images, masks, beta: float,
             eps: Optional[torch.Tensor] = None):
        with span("train.step"):
            return update(state, images, masks, beta, eps)

    if indexed:
        gather = gather or gather_batch_device

        def indexed_step(state: TrainState, data_images: torch.Tensor,
                         data_masks: torch.Tensor, idx, beta: float,
                         eps: Optional[torch.Tensor] = None):
            with span("train.step"):
                with span("train.gather"):
                    images, masks = gather(data_images, data_masks,
                                           _index_tensor(idx, data_images.device))
                return update(state, images, masks, beta, eps)

        return indexed_step
    step.compute_gradients = compute_gradients
    return step


def multi_temp_training_step(config: TrainConfig, model: torch.nn.Module, images, true_masks,
                             generator: Optional[torch.Generator], temps=(1.0, 3.0),
                             weight: float = 0.3, num_samples: int = 3,
                             eps: Optional[Tuple[torch.Tensor, ...]] = None):
    """Multi-temperature objective (reference train.py:137-160, JAX
    ``step.py:201-229``): (1 - weight) * the criterion of an eval-mode
    forward + weight * the mean over `temps` of the criterion of the mean
    logits of `num_samples` tempered draws.  Differentiable; the noise
    comes from `generator`, or from `eps` = (eps of the forward [B, D],
    then one [num_samples, B, D] per temperature).
    -> (total_loss, {'standard_loss', 'multi_temp_loss'})"""
    criterion = make_criterion(config.lesion_type)
    device = _device(model)
    model.eval()
    x = to_model_layout(images, device)
    masks = torch.as_tensor(true_masks, dtype=torch.float32, device=device)
    eps = list(eps) if eps is not None else [None] * (len(temps) + 1)
    if isinstance(model, UNetResNet):
        logits, _, _ = model(x, generator=generator, eps=eps[0])
    else:
        logits = model(x)
    standard_loss = criterion(logits.float().permute(0, 2, 3, 1), masks)
    multi = torch.zeros((), device=device)
    for t, e in zip(temps, eps[1:]):
        pred = mean_tempered_logits(model, x, generator, t, num_samples, eps=e)
        multi = multi + criterion(pred.float(), masks)
    multi = multi / len(temps)
    total = (1 - weight) * standard_loss + weight * multi
    return total, {"standard_loss": standard_loss, "multi_temp_loss": multi}


def make_eval_step(config: TrainConfig, model: torch.nn.Module,
                   apply_sigmoid_for_metrics: bool = False, indexed: bool = False,
                   gather: Optional[Callable] = None, group=None):
    """Validation step (``step.py:232-274``, reference evaluate.py:20-101).

    ``eval_step(images, masks, generator=None, valid=None, eps=None) ->
    (metrics, logits)``: eval-mode BN but a *sampled* z when the injection
    strategy samples (the reference draws it even under inference mode),
    metrics on raw logits at 0.5 unless `apply_sigmoid_for_metrics`, the
    logits resized to the mask's H x W on a mismatch, and ``valid`` ([B]
    0/1) dropping padded rows.  logits come back NHWC fp32.  The plain
    UNet's logits are its forward's (``step.py:261-265``).  ``indexed``:
    ``eval_step(data_images, data_masks, idx, generator=None, valid=None,
    eps=None)``, the batch gathered from a device cache.

    ``group``: the eval step of JAX's pjit (``parallel/dp.py:58-64``).
    Every rank takes the global batch (and its ``valid`` and ``eps``) and
    runs its contiguous block of rows; the metrics come from the sums they
    pool (``metrics.pooled_sums``) summed over the group, so they are the
    global batch's, and the logits are gathered.  The latent draw is the
    global batch's, this rank's rows of it.
    """
    is_vae = isinstance(model, UNetResNet)
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)

    @torch.inference_mode()
    def step(images, masks, generator: Optional[torch.Generator] = None,
             valid=None, eps: Optional[torch.Tensor] = None):
        model.eval()
        device = _device(model)
        x = to_model_layout(images, device)
        m = torch.as_tensor(masks, dtype=torch.float32, device=device)
        if group is not None:
            b = x.shape[0] // world
            if b * world != x.shape[0]:
                raise ValueError(f"batch {x.shape[0]} not divisible by {world} ranks")
            if eps is None and is_vae and model.should_sample and generator is not None:
                eps = gaussian_like(generator, (x.shape[0], model.latent_dim), device)
            rows = slice(rank * b, (rank + 1) * b)
            x, m = x[rows], m[rows]
            if eps is not None:
                eps = torch.as_tensor(eps, dtype=torch.float32, device=device)[rows]
            if valid is not None:
                valid = torch.as_tensor(valid, device=device)[rows]
        if config.amp:
            x = x.to(torch.bfloat16)
        if is_vae:
            logits, _, _ = model(x, generator=generator, eps=eps)
        else:
            logits = model(x)
        logits = logits.float()
        if tuple(logits.shape[2:]) != tuple(m.shape[1:3]):
            logits = resize_bilinear(logits, tuple(m.shape[1:3]), align_corners=True)
        logits = logits.permute(0, 2, 3, 1)
        if valid is not None:
            valid = torch.as_tensor(valid, device=device)
        sums = pooled_sums(logits, m, apply_sigmoid_for_metrics, valid)
        if group is None:
            return metrics_from_sums(sums), logits
        metrics = metrics_from_sums(collectives.all_reduce_sum(sums, group))
        return metrics, collectives.gather(logits.contiguous(), 0, group)

    if indexed:
        gather = gather or gather_batch_device

        @torch.inference_mode()
        def indexed_step(data_images: torch.Tensor, data_masks: torch.Tensor, idx,
                         generator: Optional[torch.Generator] = None, valid=None,
                         eps: Optional[torch.Tensor] = None):
            images, masks = gather(data_images, data_masks,
                                   _index_tensor(idx, data_images.device))
            return step(images, masks, generator, valid, eps)

        return indexed_step
    return step
