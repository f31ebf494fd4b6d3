"""Tensor parallelism for conv stacks: channel-sharded convolutions.  Port
of ``vaeunet_tpu/parallel/tp.py``.

The rule is the JAX package's (``tp.py:24-31``): a 4-D conv weight with at
least ``min_channels`` output channels is sharded on its output channels
over the 'model' axis; every other parameter is replicated.  XLA then
inserts the collectives; here :func:`shard_params` turns each such conv
into a column-parallel one (Megatron's column split):

- its weight becomes this rank's slice of Co / n_model output channels;
- its input passes :func:`ops.collectives.copy_to_group` (the identity,
  whose backward sums the input's cotangent over the model group: each
  slice contributes its part);
- the conv runs over the slice, and its output is gathered along the
  channels, differentiably (the backward keeps this rank's channels of
  the cotangent, which every model rank computes alike); a bias,
  replicated, is added after the gather.

A sharded conv that feeds a training BN still takes the conv + moments
kernel (``conv3x3_bn_stats``) on its slice: BN is per channel, so the
slice's (Σy, Σy²) are exact, and they are gathered with y.  Downstream of
the gather everything is replicated and computed alike on every model
rank, so the replicated parameters' gradients agree there to rounding;
:class:`ShardedClippedAdamW` averages them over the model group before its
clip all the same, since the card's convolution backward is not bit-exact
from run to run and replicas that differ by one rounding would drift
apart step by step.  Its clip-by-global-norm sums the sharded gradients'
squares over the model group, or the clip would differ from the unsharded
step's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import collectives
from vaeunet_tpu_torch.ops.layers import Conv
from vaeunet_tpu_torch.parallel.mesh import ParallelContext
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW, TrainState
from vaeunet_tpu_torch.training.step import average_over


def param_pspec(name: str, param: torch.Tensor, min_channels: int = 256) -> Optional[int]:
    """The dimension of parameter `name` sharded over 'model': 0, the
    output channels (HWIO dim 3 in JAX), for a 4-D conv weight of at least
    `min_channels` output channels; None (replicated) for the rest."""
    if name.endswith("weight") and param.dim() == 4 and param.shape[0] >= min_channels:
        return 0
    return None


def param_shardings(model: torch.nn.Module, min_channels: int = 256) -> Dict[str, Optional[int]]:
    """{parameter name: :func:`param_pspec`} of `model`."""
    return {n: param_pspec(n, p, min_channels) for n, p in model.named_parameters()}


class ColumnParallelConv(Conv):
    """A :class:`Conv` whose weight is this rank's slice of output channels
    (made by :func:`shard_params`)."""

    tp_group = None

    def _conv_forward(self, x, weight, bias):
        x = collectives.copy_to_group(x, self.tp_group)
        y = F.conv2d(x, weight, None, self.stride, self.padding, self.dilation, self.groups)
        y = collectives.gather(y, 1, self.tp_group, sum_grads=False)
        return y if bias is None else y + bias.view(1, -1, 1, 1)

    def conv_stats(self, x, weight):
        x = collectives.copy_to_group(x, self.tp_group)
        y, s, q = super().conv_stats(x, weight)
        return tuple(collectives.gather(t, d, self.tp_group, sum_grads=False)
                     for t, d in ((y, 1), (s, 0), (q, 0)))


def shard_params(model: torch.nn.Module, ctx: ParallelContext,
                 min_channels: int = 256) -> List[str]:
    """Make every conv the rule shards column-parallel over ``ctx.model``,
    in place -> the sharded weights' names.  Build the optimizer after
    this (:func:`shard_state` does both)."""
    if getattr(model, "use_remat", False) and getattr(model, "remat_policy", "") == "save_convs":
        raise ValueError("remat 'save_convs' keeps whole conv products; it does not compose "
                         "with channel-sharded convs (use 'full')")
    n, r = ctx.n_model, ctx.model_rank
    sharded = []
    for name, mod in model.named_modules():
        if type(mod) is not Conv or param_pspec("weight", mod.weight, min_channels) is None:
            continue
        co = mod.weight.shape[0]
        if co % n:
            raise ValueError(f"{name}: {co} output channels do not split over {n} ranks")
        part = co // n
        with torch.no_grad():
            local = mod.weight[r * part:(r + 1) * part].clone()
        mod.__class__ = ColumnParallelConv
        mod.weight = torch.nn.Parameter(local)
        mod.tp_group = ctx.model
        sharded.append(f"{name}.weight" if name else "weight")
    return sharded


class ShardedClippedAdamW(ClippedAdamW):
    """:class:`ClippedAdamW` for a model of column-parallel convs: the
    replicated parameters' gradients are averaged over the model group (one
    all-reduce), and the global norm counts the sharded parameters' whole
    tensors (their squared norms summed over the group)."""

    def __init__(self, params, config: TrainConfig, sharded: List[torch.nn.Parameter], group):
        super().__init__(params, config)
        self.sharded = {id(p) for p in sharded}
        self.group = group

    def clip_(self) -> torch.Tensor:
        parts = {True: [], False: []}
        for p in self.params:
            if p.grad is not None:
                parts[id(p) in self.sharded].append(p.grad)
        average_over(parts[False], self.group)
        zero = torch.zeros((), device=self.params[0].device)
        local = sum((torch.sum(g.float() * g.float()) for g in parts[False]), zero)
        shard = sum((torch.sum(g.float() * g.float()) for g in parts[True]), zero)
        norm = torch.sqrt(local + collectives.all_reduce_sum(shard, self.group))
        keep = norm < self.max_norm
        for g in parts[False] + parts[True]:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        return norm


def shard_state(state: TrainState, config: TrainConfig, ctx: ParallelContext,
                min_channels: int = 256) -> List[str]:
    """:func:`shard_params` on the state's model and a fresh
    :class:`ShardedClippedAdamW` in its optimizer -> the sharded names."""
    names = shard_params(state.model, ctx, min_channels)
    params = dict(state.model.named_parameters())
    state.optimizer = ShardedClippedAdamW(state.model.parameters(), config,
                                          [params[n] for n in names], ctx.model)
    return names
