"""Tensor parallelism for conv stacks: channel-sharded convolutions.  Port
of ``vaeunet_tpu/parallel/tp.py``.

The rule is the JAX package's (``tp.py:24-31``): a 4-D conv kernel whose
last (HWIO) dimension holds at least ``min_channels`` is sharded on it over
the 'model' axis; every other parameter is replicated.  That dimension is a
conv's output channels and a transposed conv's input channels (the JAX
``ConvTranspose2x`` kernel is (2, 2, out, in), ``ops/layers.py:126-128``),
which PyTorch keeps on dim 0 of both weights ([out, in, kh, kw] and
[in, out, kh, kw]).  XLA then inserts the collectives; here
:func:`shard_params` converts each module whose weight the rule names (and
raises for a module of any other type):

- a :class:`Conv` becomes column-parallel (Megatron's column split): its
  weight is this rank's slice of Co / n_model output channels; its input
  passes :func:`ops.collectives.copy_to_group` (the identity, whose
  backward sums the input's cotangent over the model group: each slice
  contributes its part); the conv runs over the slice and its output is
  gathered along the channels, differentiably (the backward keeps this
  rank's channels of the cotangent, which every model rank computes
  alike); a bias, replicated, is added after the gather;
- a :class:`ConvTranspose2x` becomes row-parallel: its weight is this
  rank's slice of Ci / n_model input channels; it takes its slice of the
  replicated input (:func:`ops.collectives.scatter_to_group`, whose
  backward gathers the slices' cotangents, since upstream is replicated),
  runs over it, and the partial outputs are summed over the model group
  (:func:`ops.collectives.reduce_from_group`, whose backward is the
  identity, since downstream is replicated: a summing backward would
  multiply the gradient by n_model); the bias is added after the sum.

A sharded conv that feeds a training BN still takes the conv + moments
kernel (``conv3x3_bn_stats``) on its slice: BN is per channel, so the
slice's (Σy, Σy²) are exact, and they are gathered with y.
``ops/layers.py::conv3x3_bn`` calls the column-parallel hooks
(``tp_input``, ``tp_output``) outside the products remat 'save_convs'
keeps, so a kept product is the slice's, replayed against the slice's
weight and gathered again in the recompute: the two compose, as the JAX
package's ``save_only_these_names`` policy and its sharding do.
Downstream of a gather or a sum everything is replicated and computed
alike on every model rank, so the replicated parameters' gradients agree
there to rounding; :class:`ShardedClippedAdamW` averages them over the
model group before its clip all the same, since the card's convolution
backward is not bit-exact from run to run and replicas that differ by one
rounding would drift apart step by step.  Its clip-by-global-norm sums the
sharded gradients' squares over the model group, or the clip would differ
from the unsharded step's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import collectives
from vaeunet_tpu_torch.ops.layers import Conv, ConvTranspose2x
from vaeunet_tpu_torch.parallel.mesh import ParallelContext
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW, TrainState
from vaeunet_tpu_torch.training.step import average_over


def param_pspec(name: str, param: torch.Tensor, min_channels: int = 256) -> Optional[int]:
    """The dimension of parameter `name` sharded over 'model': 0 (the HWIO
    last dimension in JAX: a conv's output channels, a transposed conv's
    input channels) for a 4-D weight whose dim 0 holds at least
    `min_channels`; None (replicated) for the rest."""
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

    def tp_input(self, x):
        return collectives.copy_to_group(x, self.tp_group)

    def tp_output(self, t, dim=1):
        return collectives.gather(t, dim, self.tp_group, sum_grads=False)

    def _conv_forward(self, x, weight, bias):
        y = self.tp_output(self.local_conv(self.tp_input(x), weight))
        return y if bias is None else y + bias.view(1, -1, 1, 1)


class RowParallelConvTranspose2x(ConvTranspose2x):
    """A :class:`ConvTranspose2x` whose weight is this rank's slice of input
    channels (made by :func:`shard_params`); the bias stays replicated."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = collectives.scatter_to_group(x, 1, self.tp_group)
        y = F.conv_transpose2d(xs.contiguous(memory_format=torch.channels_last),
                               self.weight.to(x.dtype), None, stride=2)
        y = collectives.reduce_from_group(y.contiguous(memory_format=torch.channels_last),
                                          self.tp_group)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1)


# module type -> its sharded class: the weight's dim 0 is what the rule shards
PARALLEL = {Conv: ColumnParallelConv, ConvTranspose2x: RowParallelConvTranspose2x}


def shard_params(model: torch.nn.Module, ctx: ParallelContext,
                 min_channels: int = 256) -> List[str]:
    """Convert every module whose weight :func:`param_shardings` names to
    its sharded class over ``ctx.model`` (:data:`PARALLEL`), in place ->
    the sharded weights' names.  Raises for a named weight of a module of
    any other type.  Build the optimizer after this (:func:`shard_state`
    does both)."""
    n, r = ctx.n_model, ctx.model_rank
    modules = dict(model.named_modules())
    sharded = []
    for pname, dim in param_shardings(model, min_channels).items():
        if dim is None:
            continue
        name = pname.rpartition(".")[0]
        mod = modules[name]
        cls = PARALLEL.get(type(mod))
        if cls is None or pname.rpartition(".")[2] != "weight":
            raise ValueError(f"{pname}: the rule shards it, but a {type(mod).__name__} has no "
                             f"sharded form")
        size = mod.weight.shape[0]
        if size % n:
            raise ValueError(f"{pname}: {size} channels do not split over {n} ranks")
        part = size // n
        with torch.no_grad():
            local = mod.weight[r * part:(r + 1) * part].clone()
        mod.__class__ = cls
        mod.weight = torch.nn.Parameter(local)
        mod.tp_group = ctx.model
        sharded.append(pname)
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

    def global_norm(self) -> torch.Tensor:
        """The replicated gradients averaged over the group in place; -> the
        norm of the whole model's gradients, the sharded ones summed over
        the group."""
        parts = {True: [], False: []}
        for p in self.params:
            if p.grad is not None:
                parts[id(p) in self.sharded].append(p.grad)
        average_over(parts[False], self.group)
        zero = torch.zeros((), device=self.params[0].device)
        local = sum((torch.sum(g.float() * g.float()) for g in parts[False]), zero)
        shard = sum((torch.sum(g.float() * g.float()) for g in parts[True]), zero)
        return torch.sqrt(local + collectives.all_reduce_sum(shard, self.group))

    def kernel_norm(self, plan) -> torch.Tensor:
        """:meth:`global_norm`: the norm takes a collective, so the update
        kernel clips by the norm of torch's ops."""
        return self.global_norm()


def shard_state(state: TrainState, config: TrainConfig, ctx: ParallelContext,
                min_channels: int = 256) -> List[str]:
    """:func:`shard_params` on the state's model and a fresh
    :class:`ShardedClippedAdamW` in its optimizer -> the sharded names."""
    names = shard_params(state.model, ctx, min_channels)
    params = dict(state.model.named_parameters())
    state.optimizer = ShardedClippedAdamW(state.model.parameters(), config,
                                          [params[n] for n in names], ctx.model)
    return names
