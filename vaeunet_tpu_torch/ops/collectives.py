"""Differentiable collectives over a ``torch.distributed`` process group.

New in the port: the JAX package gets its collectives from XLA once a
mesh axis is named (``psum`` / ``pmean`` under ``shard_map``, inserted
all-reduces and all-gathers under ``pjit``).  Here they are five autograd
Functions, each built on ``all_reduce`` alone, the one collective that
every backend takes for CUDA tensors (gloo's CUDA support covers
``all_reduce`` and ``broadcast`` but not ``all_gather`` or
``reduce_scatter``), so that two ranks sharing one card over gloo run the
same code as ranks on their own cards over NCCL:

- :func:`all_reduce_sum`: the sum over the group, whose backward is the
  sum of the cotangents over the group (the BN moments of a global batch);
- :func:`gather`: the ranks' tensors concatenated along a dimension in rank
  order, as a sum of zero-padded copies (exact: each element is added to
  zeros only), whose backward keeps this rank's part of the cotangent,
  summed over the group first where each rank's cotangent is its own
  copy's to be summed (``sum_grads``: the global-batch loss that every rank
  computes and whose gradients are then averaged) or not where the ranks
  compute one replicated result (the column-parallel outputs);
- :func:`copy_to_group`: the identity, whose backward sums the cotangents
  over the group (the input of a column-parallel conv: each rank's slice
  of output channels contributes its part of the input's gradient);
- :func:`scatter_to_group`: this rank's part of a replicated tensor along a
  dimension, whose backward gathers the parts' cotangents (the input of a
  row-parallel conv: upstream is replicated, so every rank needs the whole
  gradient);
- :func:`reduce_from_group`: the sum over the group, whose backward is the
  identity (a row-parallel conv's partial outputs: downstream is
  replicated, so each rank's cotangent is already the whole one, and
  summing it would multiply the gradient by the group's size).

:func:`rank_rows` decides which rows of a global batch a data rank holds
(the step, the loop's ``shard_batch`` and the tests all take it from here).

bf16 tensors cross the wire as fp32 (exact both ways), since gloo's
reductions need not take bf16.  A failed collective raises; nothing here
falls back to a local result.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.distributed as dist


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A contiguous view of `x`'s storage (channels_last as NHWC)."""
    if x.is_contiguous():
        return x
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1)
    raise ValueError(f"collective on a tensor of strides {x.stride()}: not dense")


def _reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place (fp32 on the wire for bf16); -> x."""
    flat = _dense(x)
    if x.dtype == torch.bfloat16:
        wide = flat.float()
        dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
        flat.copy_(wide)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ctx.group), None


def _format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)


def _gather(x: torch.Tensor, dim: int, group, fmt) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, as a sum of zero-padded
    copies (exact), in memory format `fmt`."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    part = shape[dim]
    shape[dim] *= world
    out = torch.zeros(shape, dtype=x.dtype, device=x.device).contiguous(memory_format=fmt)
    out.narrow(dim, rank * part, part).copy_(x)
    return _reduce_(out, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grads):
        ctx.dim, ctx.group, ctx.sum_grads = dim, group, sum_grads
        ctx.part, ctx.fmt = x.shape[dim], _format(x)
        return _gather(x, dim, group, ctx.fmt)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _reduce_(g.clone(), ctx.group)
        part = g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.part, ctx.part)
        return part.contiguous(memory_format=ctx.fmt), None, None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.fmt = dim, group, _format(x)
        world = dist.get_world_size(group)
        if x.shape[dim] % world:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {world} ranks")
        part = x.shape[dim] // world
        return x.narrow(dim, dist.get_rank(group) * part, part)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(memory_format=ctx.fmt), ctx.dim, ctx.group, ctx.fmt), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rank_rows(n: int, n_data: int, data_rank: int, accum: int = 1) -> np.ndarray:
    """Indices of the rows of an `n`-row global batch that data rank
    `data_rank` holds, in order.  ``accum`` = 1: the contiguous block
    ``P('data')`` gives it.  ``accum`` > 1: its share of each of the `accum`
    microbatches in turn, so that microbatch i of every rank together is
    microbatch i of the global batch (rows i*n/accum ... (i+1)*n/accum - 1),
    as the single-device step splits it."""
    if n % (n_data * accum):
        raise ValueError(f"batch {n} not divisible by {n_data} ranks x {accum} microbatches")
    micro_g = n // accum
    micro = micro_g // n_data
    return np.concatenate([i * micro_g + data_rank * micro + np.arange(micro)
                           for i in range(accum)])


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of `group` (a new tensor; differentiable)."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself forward; the cotangent summed over `group` backward."""
    return _CopyToGroup.apply(x, group)


def scatter_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of `x` along `dim` forward; the parts'
    cotangents gathered over `group` backward."""
    return _ScatterToGroup.apply(x, dim, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of `group` forward (a new tensor); the cotangent
    itself backward."""
    return _ReduceFromGroup.apply(x, group)


def gather(x: torch.Tensor, dim: int, group, sum_grads: bool = True) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim` in rank
    order, on every rank.  Differentiable where a graph is being recorded
    through `x`; the backward sums the cotangents over the group before
    keeping this rank's part, unless `sum_grads` is False."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        with torch.no_grad():
            return _Gather.apply(x.detach(), dim, group, sum_grads)
    return _Gather.apply(x, dim, group, sum_grads)
