"""Data-parallel training over ranks.  Port of ``vaeunet_tpu/parallel/dp.py``.

The two mechanisms of the JAX package, each as one rank's step (every
rank of the data group calls it on its rows of the global batch,
``mesh.shard_batch``):

- **global batch (default)**, the counterpart of the pjit step: XLA
  computes the single-chip step on the global logical batch, so BN sees
  the global batch statistics (``dp.py:4-9``).  Here each training
  BatchNorm sums its moments over the ranks (``ops/layers.py``), the loss
  is computed on the gathered logits, the random draws are the global
  batch's, and the gradients are averaged: the step of one device on the
  global batch, to rounding.
- **per-device** (``explicit=True``), the counterpart of ``shard_map`` +
  ``pmean``: each rank normalizes with its own rows' statistics and draws
  its own noise; gradients, losses and BN running statistics are averaged
  (``training/step.py``'s ``group``; torch DDP's semantics).

Gradients are averaged in one flattened all-reduce before the clip and
AdamW (``step.py:168-169``).  DDP is not used: its hooks average during
the backward, while the port's step accumulates microbatches and clips by
hand (``ClippedAdamW``); one explicit all-reduce after the backward gives
the JAX step's order with no hook to keep in step.

``train_model_dp`` runs the training loop on one rank with these steps:
host-fed batches (no device cache under DP, as ``loop.py:160-161``), every
rank drawing the same seeded global batch and keeping its rows; only rank
0 writes checkpoints and tracking.  :func:`run_train_dp` launches it on N
ranks (the train CLI's ``--num-devices N``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional

import torch

from vaeunet_tpu_torch.parallel.mesh import ParallelContext, launch, shard_batch
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import create_train_state
from vaeunet_tpu_torch.training.step import make_eval_step, make_train_step

log = logging.getLogger(__name__)


def make_dp_train_step(config: TrainConfig, ctx: ParallelContext, model: torch.nn.Module,
                       explicit: bool = False, augment: bool = False):
    """-> ``step(state, images, masks, beta, eps=None)`` on this rank's rows
    (``shard_batch(ctx, ..., accum=...)``; ``eps`` this rank's rows of the
    noise); every rank of the data group calls it."""
    return make_train_step(config, model, augment=augment, group=ctx.data,
                           global_batch=not explicit)


def make_dp_eval_step(config: TrainConfig, ctx: ParallelContext, model: torch.nn.Module):
    """-> ``step(images, masks, generator=None, valid=None, eps=None)`` on
    the global batch: each rank runs its rows; metrics of the global batch
    under ``valid``, logits gathered."""
    return make_eval_step(config, model, group=ctx.data)


def train_model_dp(config: TrainConfig, ctx: ParallelContext,
                   model_state: Optional[Mapping[str, torch.Tensor]] = None,
                   **kwargs) -> Any:
    """Data-parallel ``train_model`` on this rank: the same control flow,
    the global-batch steps.  The effective batch is global and must divide
    by the data axis (``dp.py:78-81``), as must the validation batch."""
    from vaeunet_tpu_torch.training.loop import train_model

    n_data = ctx.n_data
    accum = max(1, config.gradient_accumulation_steps)
    eff = config.batch_size * accum
    if eff % n_data or config.batch_size % n_data:
        raise ValueError(f"effective batch {eff} (batch {config.batch_size}) not divisible "
                         f"by data axis {n_data}")
    if (eff // n_data) % accum:
        raise ValueError(f"this rank's {eff // n_data} rows do not split into {accum} "
                         "microbatches")
    log.info("Data-parallel training over mesh %s (%s)", ctx.shape, ctx.backend)
    state = create_train_state(config, seed=config.seed, device=ctx.device)
    if model_state is not None:
        state.model.load_state_dict(model_state)
    train_step = make_dp_train_step(config, ctx, state.model, augment=True)
    eval_step = make_dp_eval_step(config, ctx, state.model)

    def place(images, masks):
        return shard_batch(ctx, images, masks, accum=accum)

    return train_model(config, state=state, train_step=train_step, eval_step=eval_step,
                       place_batch=place, device=ctx.device, writer=ctx.rank == 0, **kwargs)


def _train_rank(ctx: ParallelContext, config: TrainConfig,
                model_state: Optional[Dict[str, torch.Tensor]],
                kwargs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """One rank of :func:`run_train_dp`; rank 0 returns the final step and
    weights."""
    logging.basicConfig(level=logging.INFO if ctx.rank == 0 else logging.WARNING,
                        format=f"%(levelname)s [rank {ctx.rank}]: %(message)s")
    state = train_model_dp(config, ctx, model_state=model_state, **kwargs)
    if ctx.rank != 0:
        return None
    return {"step": state.step,
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def run_train_dp(config: TrainConfig, device: str = "cuda",
                 model_state: Optional[Mapping[str, torch.Tensor]] = None,
                 timeout: float = 7 * 24 * 3600.0, **kwargs) -> Dict[str, Any]:
    """Launch ``config.num_devices`` ranks of :func:`train_model_dp` on
    `device` (one card each; gloo ranks on the CPU) -> rank 0's final
    ``{"step", "model"}`` (weights on the host).  `kwargs` go to
    ``train_model`` (``resume_from``, ...)."""
    sd = None if model_state is None else {k: v.detach().cpu() for k, v in model_state.items()}
    results = launch(_train_rank, config.num_devices, args=(config, sd, kwargs),
                     device=device, timeout=timeout)
    return results[0]

