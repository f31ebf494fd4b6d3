"""Training-mode BatchNorm (+ ReLU or SiLU) from the conv kernel's moments: the CUDA
kernels' wrapper, their plain versions and the autograd Function.  New in
the port: the JAX package leaves this math to XLA, which fuses it after
``conv3x3_bn_stats``; it has no Pallas kernel.

``bn_train(y, s, q, weight, bias, relu, eps, running) -> out``: y a
channels_last NCHW tensor (float32 or bfloat16), ``s`` and ``q`` its fp32
per-channel sum and sum of squares over (N, H, W) (``conv3x3_bn_stats``'s
moments), weight and bias the fp32 affine parameters.  With n = N H W:
mean = s / n, var = max(q / n - mean^2, 0), out = (y - mean) rsqrt(var +
eps) weight + bias in fp32, rounded to y's type, then ReLU if `relu`: the
ops of ``BatchNorm.forward_moments`` and ``F.relu``, whose bits the CUDA
forward gives.  ``running`` (:class:`Running`), where given, moves the
running statistics as ``forward_moments`` moves them (momentum, the
unbiased var n / (n - 1), the batch counter); None inside a remat
recompute.

The backward treats s and q as the moments of y that they are: it returns
one cotangent dy that already holds the paths through s and q, and None for
s and q, so the conv's backward takes dy as it is.  With g' the output's
cotangent masked where the forward's out <= 0 (relu), A = sum g' and B =
sum g' (y - mean) a channel:

    dy = inv g' + k0 + k1 (y - mean),  k0 = -inv A / n,  k1 = 2 dvar' / n,

where inv = rsqrt(var + eps) weight and dvar' = -B weight r^3 / 2 (r =
rsqrt(var + eps)) where q / n - mean^2 >= 0, else 0 (the clamp's gradient);
dweight = B r, dbias = A.  B is centred on the mean, the same sum as
sum g' y - mean A without its cancellation.  dy is computed in fp32 and
rounded once to y's type (autograd of the torch ops rounded the direct
part to bf16 before the moments' cotangents were added to it).

A CUDA tensor goes to ``csrc/bn_train.cu``: one launch forward, two
backward (the sums, then dy), counted as ``bn_train_fwd`` and
``bn_train_bwd``.  A CPU tensor goes to :func:`bn_train_plain` and
:func:`bn_train_backward_plain`.

``bn_batch(x, weight, bias, act, eps, running) -> out`` is the same BN for
a tensor that comes without its moments: every training-mode BN outside the
fused 3x3 sites (``ops/layers.py::BatchNorm.forward``).  s and q are x's own
fp32 sum and sum of squares, and the rest is ``bn_train``'s math, backward
included.  On the card it is the ``bn_batch_`` kernels of the same source:
one C call forward (the moments pass, then the normalisation) and one
backward (the two passes above), counted as ``bn_batch_fwd`` and
``bn_batch_bwd`` (and ``bn_batch_silu``, a SiLU forward), with x's bytes in
``bn_batch_bytes`` while a profiler session runs.  On the CPU:
:func:`bn_batch_plain`.

The activation ``act`` is :data:`IDENTITY` (or False), :data:`RELU` (or
True) or, for ``bn_batch`` alone, :data:`SILU`: out = z sigmoid(z) on the
normalised z rounded to x's type (``F.silu``), whose backward takes g' = g
s (1 + z (1 - s)), s = sigmoid(z), with z recomputed from x and the moments
as the ReLU's mask is.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu

_DTYPES = (torch.float32, torch.bfloat16)
# the activation after the normalisation (the kernels' Act; a bool is ReLU or none)
IDENTITY, RELU, SILU = 0, 1, 2
# the sums pass: channel vectors across a block (the rest along its rows),
# and blocks an SM, which bound the partial rows its last block adds up
REDUCE_VECS = 32
REDUCE_BLOCKS_PER_SM = 2


class Running(NamedTuple):
    """A BatchNorm's running statistics and how they move."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor          # num_batches_tracked, int64
    momentum: float


def fold_moments(s: torch.Tensor, q: torch.Tensor, n: int, eps: float, weight: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, inv = rsqrt(var + eps) * weight) from the moments of n rows."""
    mean = s / n
    var = torch.clamp(q / n - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + eps) * weight


def move_running(running: Running, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    with torch.no_grad():
        m = running.momentum
        running.mean.mul_(1.0 - m).add_(mean, alpha=m)
        running.var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
        running.count.add_(1)


def normalize_plain(y: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """(y - mean) * inv + bias per channel in fp32, in y's type."""
    shape = (1, -1, 1, 1)
    out = (y.float() - mean.view(shape)) * inv.view(shape) + bias.view(shape)
    return out.to(y.dtype)


def activate_plain(out: torch.Tensor, act: int) -> torch.Tensor:
    """`out` through the activation: ``F.relu``, ``F.silu`` or as it is."""
    if act == SILU:
        return F.silu(out)
    return F.relu(out) if act else out


def bn_train_plain(y: torch.Tensor, s: torch.Tensor, q: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, act: int, eps: float = 1e-5,
                   running: Optional[Running] = None) -> torch.Tensor:
    """The forward in torch ops: ``BatchNorm.forward_moments``, then
    ``F.relu`` or ``F.silu`` (`act`)."""
    n = y.numel() // y.shape[1]
    mean, var, inv = fold_moments(s, q, n, eps, weight)
    if running is not None:
        move_running(running, mean, var, n)
    return activate_plain(normalize_plain(y, mean, inv, bias), act)


def bn_train_backward_plain(g: torch.Tensor, y: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor, act: int,
                            eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy, dweight, dbias) in closed form (module docstring), torch ops."""
    c = y.shape[1]
    n = y.numel() // c
    shape = (1, c, 1, 1)
    mean, var, inv = fold_moments(s, q, n, eps, weight)
    r = torch.rsqrt(var + eps)
    yc = y.float() - mean.view(shape)
    g = g.float()
    if act:
        z = (yc * inv.view(shape) + bias.view(shape)).to(y.dtype).float()
        if act == SILU:
            sg = torch.sigmoid(z)
            g = g * sg * (1.0 + z * (1.0 - sg))
        else:
            g = torch.where(z <= 0, torch.zeros_like(g), g)
    a = g.sum((0, 2, 3))
    b = (g * yc).sum((0, 2, 3))
    dvar = -0.5 * (b * weight) * r * r * r
    dvar = torch.where(q / n - mean * mean >= 0, dvar, torch.zeros_like(dvar))
    k0, k1 = -inv * a / n, 2.0 * dvar / n
    dy = g * inv.view(shape) + k0.view(shape) + k1.view(shape) * yc
    return dy.to(y.dtype).contiguous(memory_format=torch.channels_last), b * r, a


class Plan(NamedTuple):
    """The backward's two launches: the sums pass's route, vector width,
    block and grid, and the dy pass's (bn_relu's plan)."""
    reduce: bn_relu.Plan
    apply: bn_relu.Plan


def reduce_plan(rows: int, channels: int, elem_size: int, aligned: bool, sms: int
                ) -> bn_relu.Plan:
    """The sums pass: bn_relu's route and width; a block of at most
    ``REDUCE_VECS`` channel vectors (the rest in chunks along the grid's y)
    by as many rows as fill ``THREADS``; ``REDUCE_BLOCKS_PER_SM`` x `sms`
    blocks in all, fewer where the rows run out, each walking its share of
    the rows and writing one partial row, so that the last block adds up
    few rows.  bn_batch's moments pass walks the same way."""
    p = bn_relu.plan(rows, channels, elem_size, aligned)
    vecs = channels // p.vec
    block_x = min(vecs, REDUCE_VECS)
    block_y = bn_relu.THREADS // block_x
    chunks = -(-vecs // block_x)
    groups = -(-rows // (block_y * bn_relu.ROWS_IN_FLIGHT))
    blocks = max(1, -(-REDUCE_BLOCKS_PER_SM * sms // chunks))
    return bn_relu.Plan(p.route, p.vec, (block_x, block_y), (min(groups, blocks), chunks))


def plan(rows: int, channels: int, elem_size: int, aligned: bool, sms: int) -> Plan:
    return Plan(reduce_plan(rows, channels, elem_size, aligned, sms),
                bn_relu.plan(rows, channels, elem_size, aligned))


def _check(y: torch.Tensor, *named, op: str = "bn_train") -> None:
    if y.dim() != 4 or y.numel() == 0:
        raise ValueError(f"{op} expects a non-empty NCHW tensor, got {tuple(y.shape)}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"{op} takes float32 or bfloat16, not {y.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{op} expects a channels_last-contiguous tensor")
    c, device = y.shape[1], y.device
    for name, v in named:
        if (v.dtype is not torch.float32 or v.shape != (c,) or v.device != device
                or not v.is_contiguous()):
            raise ValueError(f"{op}: {name} must be a contiguous float32 [{c}] on {device}")


def _check_running(y: torch.Tensor, running: Running, op: str = "bn_train") -> None:
    _check(y, ("running mean", running.mean), ("running var", running.var), op=op)
    if (running.count.dtype is not torch.int64 or running.count.numel() != 1
            or running.count.device != y.device):
        raise ValueError(f"{op}: the batch counter must be one int64 on {y.device}")


def inverse_n(n: int) -> float:
    """1 / n rounded in fp32: torch's CUDA division by a host scalar
    multiplies by it."""
    return float(np.float32(1.0) / np.float32(n))


# (pass, rows, C, dtype, aligned[, device]) -> the plan's launch arguments
# and the scalars of n: the lookup is on every call's path
_PLANS: Dict[tuple, tuple] = {}
_PLANS_MOST = 1024
# device index -> its SM count, and its tickets: one int32 a channel chunk of
# the sums pass, zero between launches (the last block of a chunk resets its
# own), so two backward launches on one device must not overlap: the port
# launches on one stream
_SMS: Dict[int, int] = {}
_TICKETS: Dict[int, torch.Tensor] = {}


def _cached(key: tuple, make):
    got = _PLANS.get(key)
    if got is None:
        if len(_PLANS) >= _PLANS_MOST:
            _PLANS.clear()
        got = _PLANS[key] = make()
    return got


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def tickets(device: torch.device, chunks: int) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    t = _TICKETS.get(index)
    if t is None or t.numel() < chunks:
        t = _TICKETS[index] = torch.zeros(max(chunks, 64), dtype=torch.int32, device=device)
    return t


def forward_launch_args(y, out, s, q, weight, bias, relu: bool, eps: float,
                        running: Optional[Running]):
    """(C entry, arguments less the stream) of the forward from `y` into
    `out`, both channels_last."""
    c = y.shape[1]
    rows = y.numel() // c
    aligned = (y.data_ptr() | out.data_ptr()) % bn_relu.VEC_BYTES == 0

    def make():
        p = bn_relu.plan(rows, c, y.element_size(), aligned)
        return inverse_n(rows), rows / max(rows - 1, 1), (rows, c, p.vec, *p.block, *p.grid)

    inv_n, unbias, planned = _cached(("fwd", rows, c, y.dtype, aligned), make)
    if running is None:
        stats, m, flags = (0, 0, 0), 0.0, 0
    else:
        stats = (running.mean.data_ptr(), running.var.data_ptr(), running.count.data_ptr())
        m, flags = running.momentum, 2
    fn = "vaeunet_bn_train_fwd_f32" if y.dtype == torch.float32 else "vaeunet_bn_train_fwd_bf16"
    return fn, (y.data_ptr(), out.data_ptr(), s.data_ptr(), q.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), *stats, inv_n, eps, m, 1.0 - m, unbias, *planned,
                flags | int(relu))


def _forward_cuda(y, s, q, weight, bias, relu: bool, eps: float,
                  running: Optional[Running]) -> torch.Tensor:
    out = torch.empty_like(y, memory_format=torch.channels_last)
    fn, args = forward_launch_args(y, out, s, q, weight, bias, relu, eps, running)
    _ext.call("bn_train", fn, y.device, *args)
    _ext.count_launch("bn_train_fwd")
    return out


def backward_launch_args(g, y, dy, s, q, weight, bias, relu: bool, eps: float):
    """(C entry, arguments less the stream, (dweight, dbias) it fills, the
    scratch to keep alive until the launch) of the backward from `g` into
    `dy`, all three channels_last and of y's type."""
    return _backward_args("vaeunet_bn_train_bwd_", g, y, dy, s.data_ptr(), q.data_ptr(), weight,
                          bias, relu, eps)


def _backward_args(entry: str, g, y, dy, s_ptr: int, q_ptr: int, weight, bias, act: int,
                   eps: float):
    c = y.shape[1]
    rows = y.numel() // c
    aligned = (g.data_ptr() | y.data_ptr() | dy.data_ptr()) % bn_relu.VEC_BYTES == 0
    p, inv_n = _cached(("bwd", rows, c, y.dtype, aligned, y.device),
                       lambda: (plan(rows, c, y.element_size(), aligned, _sms(y.device)),
                                inverse_n(rows)))
    # coef [2, C] first (16-byte aligned for the vector loads), then the
    # partial rows [blocks, 2, C]
    scratch = torch.empty((p.reduce.grid[0] + 1) * 2 * c, dtype=torch.float32, device=y.device)
    grads = torch.empty((2, c), dtype=torch.float32, device=y.device)
    ticket = tickets(y.device, p.reduce.grid[1])
    base = scratch.data_ptr()
    fn = entry + ("f32" if y.dtype == torch.float32 else "bf16")
    args = (g.data_ptr(), y.data_ptr(), dy.data_ptr(), s_ptr, q_ptr, weight.data_ptr(), bias.data_ptr(), base + 8 * c, ticket.data_ptr(), base,
            grads[0].data_ptr(), grads[1].data_ptr(), inv_n, eps, rows, c, p.apply.vec,
            *p.reduce.block, *p.reduce.grid, *p.apply.block, *p.apply.grid, int(act))
    return fn, args, (grads[0], grads[1]), (scratch, ticket)


def _backward_cuda(g, y, s, q, weight, bias, relu: bool, eps: float):
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    fn, args, (dw, db), _ = backward_launch_args(g, y, dy, s, q, weight, bias, relu, eps)
    _ext.call("bn_train", fn, y.device, *args)
    _ext.count_launch("bn_train_bwd")
    return dy, dw, db


class _BnTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, s, q, weight, bias, relu, eps, running):
        ctx.set_materialize_grads(False)
        if y.device.type == "cpu":
            out = bn_train_plain(y, s, q, weight, bias, relu, eps, running)
        elif y.device.type == "cuda":
            out = _forward_cuda(y, s, q, weight, bias, relu, eps, running)
        else:
            raise ValueError(f"bn_train: unsupported device {y.device}")
        ctx.relu, ctx.eps = relu, eps
        ctx.save_for_backward(y, s, q, weight, bias)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if g is None:
            return (None,) * 8
        y, s, q, weight, bias = ctx.saved_tensors
        if g.dtype != y.dtype or not g.is_contiguous(memory_format=torch.channels_last):
            g = g.to(y.dtype).contiguous(memory_format=torch.channels_last)
        if y.device.type == "cpu":
            dy, dw, db = bn_train_backward_plain(g, y, s, q, weight, bias, ctx.relu, ctx.eps)
        else:
            dy, dw, db = _backward_cuda(g, y, s, q, weight, bias, ctx.relu, ctx.eps)
        need = ctx.needs_input_grad
        return (dy, None, None, dw if need[3] else None, db if need[4] else None,
                None, None, None)


def bn_train(y: torch.Tensor, s: torch.Tensor, q: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor, relu: bool, eps: float = 1e-5,
             running: Optional[Running] = None) -> torch.Tensor:
    """Training-mode BN (+ ReLU) of `y` from its moments; see the module
    docstring.  Differentiable in y (through s and q as well) and in the
    affine parameters."""
    _check(y, ("s", s), ("q", q), ("weight", weight), ("bias", bias))
    if running is not None:
        _check_running(y, running)
    return _BnTrain.apply(y, s, q, weight, bias, relu, eps, running)


# ----- training BN over the batch's own moments ------------------------------

def batch_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """[2, C]: x's fp32 sum and sum of squares over (N, H, W)."""
    x32 = x.float()
    return torch.stack([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))])


def bn_batch_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act: int,
                   eps: float = 1e-5, running: Optional[Running] = None) -> torch.Tensor:
    """The forward in torch ops: :func:`bn_train_plain` on x's own moments."""
    s, q = batch_moments_plain(x)
    return bn_train_plain(x, s, q, weight, bias, act, eps, running)


def act_flags(act: int) -> int:
    """The forward entries' activation flags: 1 ReLU, 4 SiLU."""
    return 4 if act == SILU else int(bool(act))


def batch_forward_launch_args(x, out, weight, bias, act: int, eps: float,
                              running: Optional[Running]):
    """(C entry, arguments less the stream, the fp32 scratch whose first
    2 C values the launch fills with s and q) of the forward from `x` into
    `out`, both channels_last.  The rest of the scratch is the moments
    pass's partial rows, [blocks, 2, C]."""
    c = x.shape[1]
    rows = x.numel() // c
    aligned = (x.data_ptr() | out.data_ptr()) % bn_relu.VEC_BYTES == 0

    def make():
        p = plan(rows, c, x.element_size(), aligned, _sms(x.device))
        return (inverse_n(rows), rows / max(rows - 1, 1), (p.reduce.grid[0] + 1) * 2 * c,
                p.reduce.grid[1], (rows, c, p.apply.vec, *p.reduce.block, *p.reduce.grid,
                                   *p.apply.block, *p.apply.grid))

    inv_n, unbias, scratch_len, chunks, planned = _cached(
        ("batch", rows, c, x.dtype, aligned, x.device), make)
    scratch = torch.empty(scratch_len, dtype=torch.float32, device=x.device)
    ticket = tickets(x.device, chunks)
    if running is None:
        stats, m, flags = (0, 0, 0), 0.0, 0
    else:
        stats = (running.mean.data_ptr(), running.var.data_ptr(), running.count.data_ptr())
        m, flags = running.momentum, 2
    base = scratch.data_ptr()
    fn = "vaeunet_bn_batch_fwd_f32" if x.dtype == torch.float32 else "vaeunet_bn_batch_fwd_bf16"
    return fn, (x.data_ptr(), out.data_ptr(), base, base + 8 * c, ticket.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), *stats, inv_n, eps, m, 1.0 - m, unbias,
                *planned, flags | act_flags(act)), scratch


def batch_backward_launch_args(g, x, dx, moments, weight, bias, act: int, eps: float):
    """:func:`backward_launch_args` of the ``bn_batch_`` kernels, with s and
    q the first 2 C values of `moments` (the forward's scratch)."""
    c = x.shape[1]
    base = moments.data_ptr()
    return _backward_args("vaeunet_bn_batch_bwd_", g, x, dx, base, base + 4 * c, weight, bias,
                          act, eps)


def _batch_forward_cuda(x, weight, bias, act: int, eps: float, running: Optional[Running]):
    out = torch.empty_like(x, memory_format=torch.channels_last)
    fn, args, moments = batch_forward_launch_args(x, out, weight, bias, act, eps, running)
    _ext.call("bn_train", fn, x.device, *args)
    _ext.count_launch("bn_batch_fwd")
    if act == SILU:
        _ext.count_launch("bn_batch_silu")
    _ext.count_bytes("bn_batch_bytes", x)
    return out, moments


def _batch_backward_cuda(g, x, moments, weight, bias, act: int, eps: float):
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    fn, args, (dw, db), _ = batch_backward_launch_args(g, x, dx, moments, weight, bias, act, eps)
    _ext.call("bn_train", fn, x.device, *args)
    _ext.count_launch("bn_batch_bwd")
    return dx, dw, db


class _BnBatch(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, act, eps, running):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            moments = batch_moments_plain(x)
            out = bn_train_plain(x, moments[0], moments[1], weight, bias, act, eps, running)
            moments = moments.view(-1)
        elif x.device.type == "cuda":
            out, moments = _batch_forward_cuda(x, weight, bias, act, eps, running)
        else:
            raise ValueError(f"bn_batch: unsupported device {x.device}")
        ctx.act, ctx.eps = act, eps
        ctx.save_for_backward(x, moments, weight, bias)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if g is None:
            return (None,) * 6
        x, moments, weight, bias = ctx.saved_tensors
        if g.dtype != x.dtype or not g.is_contiguous(memory_format=torch.channels_last):
            g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        if x.device.type == "cpu":
            c = x.shape[1]
            dx, dw, db = bn_train_backward_plain(g, x, moments[:c], moments[c:2 * c], weight,
                                                 bias, ctx.act, ctx.eps)
        else:
            dx, dw, db = _batch_backward_cuda(g, x, moments, weight, bias, ctx.act, ctx.eps)
        need = ctx.needs_input_grad
        return dx, dw if need[1] else None, db if need[2] else None, None, None, None


def bn_batch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act: int,
             eps: float = 1e-5, running: Optional[Running] = None) -> torch.Tensor:
    """Training-mode BN (+ ReLU or SiLU, `act`) of `x` over its own batch
    statistics; see the module docstring.  A tensor that is not
    channels_last-contiguous is made so first.  Differentiable in x and the
    affine parameters."""
    act = int(act)
    if act not in (IDENTITY, RELU, SILU):
        raise ValueError(f"bn_batch: activation {act} is none of 0, 1, 2")
    x = x.contiguous(memory_format=torch.channels_last)
    _check(x, ("weight", weight), ("bias", bias), op="bn_batch")
    if running is not None:
        _check_running(x, running, op="bn_batch")
    if x.numel() == x.shape[1]:
        raise ValueError(f"bn_batch: expected more than 1 value per channel when training, "
                         f"got input size {tuple(x.shape)}")
    return _BnBatch.apply(x, weight, bias, act, eps, running)
