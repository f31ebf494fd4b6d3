"""Fused eval-mode BatchNorm + ReLU: the CUDA kernel's wrapper and its plain
version.  Port of ``vaeunet_tpu/ops/pallas/bn_relu.py``.

y = max(0, (x - mean) * rsqrt(var + eps) * scale + bias), with the affine
part folded in fp32 to ``a = scale * rsqrt(var + eps)`` and
``b = bias - mean * a`` exactly as the JAX kernel folds it.

``x`` is NCHW in ``torch.channels_last`` memory (physically NHWC, the
layout the kernel ``csrc/bn_relu.cu`` reads).  A CUDA tensor goes to the
kernel, which folds the running statistics itself: one launch a call and no
torch op.  A CPU tensor goes through :func:`fold` to
:func:`fused_bn_relu_plain`.  :func:`plan` is the kernel's route, block and
grid, made from the shape and the addresses alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vaeunet_tpu_torch.ops import _ext

_DTYPES = (torch.float32, torch.bfloat16)

VEC_BYTES = 16          # one thread's load or store on the vector route
THREADS = 256           # the most threads a block holds
ROWS_IN_FLIGHT = 4      # rows a thread loads before its first store (kRowsInFlight)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


def fold(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
         var: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running statistics -> per-channel (a, b), fp32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b


def fused_bn_relu_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(x * a + b, 0) per channel in fp32, cast back to x's dtype."""
    shape = (1, -1, 1, 1)
    y = x.float() * a.view(shape) + b.view(shape)
    return torch.relu(y).to(x.dtype)


class Plan(NamedTuple):
    """How one call runs on the card."""
    route: str                  # "vector" or "scalar"
    vec: int                    # channels a thread takes: 16 bytes of them, or 1
    block: Tuple[int, int]      # (channel vectors, rows)
    grid: Tuple[int, int]       # (row groups, channel chunks)


def plan(rows: int, channels: int, elem_size: int, aligned: bool) -> Plan:
    """The route, block and grid of a call on a [rows, channels] tensor
    (rows = N * H * W) of `elem_size` bytes an element; `aligned`: the
    input and the output start on 16-byte addresses.  The vector route
    needs that and a whole number of 16-byte vectors in a pixel; every
    other tensor takes the scalar route.  A thread keeps one channel vector
    and makes ``ROWS_IN_FLIGHT`` rows of it at a time; a block is as many
    vectors as a pixel has (at most ``THREADS``, the rest in chunks along
    the grid's y) by as many rows as fill ``THREADS``; the grid covers the
    rows once."""
    vec = VEC_BYTES // elem_size
    route = "vector" if aligned and channels % vec == 0 else "scalar"
    if route == "scalar":
        vec = 1
    vecs = channels // vec
    block_x = min(vecs, THREADS)
    block_y = THREADS // block_x
    chunks = -(-vecs // block_x)
    if chunks > MAX_GRID_Y:
        raise ValueError(f"bn_relu: {channels} channels exceed the grid")
    groups = -(-rows // (block_y * ROWS_IN_FLIGHT))
    return Plan(route, vec, (block_x, block_y), (min(groups, MAX_GRID_X), chunks))


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"bn_relu expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_relu takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_relu expects a channels_last-contiguous tensor")


def _check_vectors(x: torch.Tensor, *named) -> None:
    c, device = x.shape[1], x.device
    shape = (c,)
    for name, v in named:
        if (v.dtype is not torch.float32 or v.shape != shape or v.device != device
                or not v.is_contiguous()):
            raise ValueError(f"bn_relu: {name} must be a contiguous float32 [{c}] on {device}")


# (rows, C, dtype, aligned) -> the plan's launch arguments: the lookup is on
# every call's path
_PLANS: dict = {}
_PLANS_MOST = 1024


def launch_args(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor, eps: float):
    """(C entry, arguments) of one launch from `x` into `y`, both
    channels_last and not empty (the stream is appended by ``_ext.call``)."""
    c = x.shape[1]
    rows = x.numel() // c
    aligned = (x.data_ptr() | y.data_ptr()) % VEC_BYTES == 0
    key = (rows, c, x.dtype, aligned)
    planned = _PLANS.get(key)
    if planned is None:
        if len(_PLANS) >= _PLANS_MOST:
            _PLANS.clear()
        p = plan(rows, c, x.element_size(), aligned)
        planned = _PLANS[key] = (rows, c, p.vec, *p.block, *p.grid)
    fn = "vaeunet_bn_relu_f32" if x.dtype == torch.float32 else "vaeunet_bn_relu_bf16"
    return fn, (x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                mean.data_ptr(), var.data_ptr(), eps, *planned)


def fused_bn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Folded eval BN + ReLU of a channels_last NCHW tensor.  On the card
    the statistics go to the kernel as they are (float32 [C], contiguous,
    on x's device; anything else raises) and it folds them itself; it has
    no backward, so it raises under autograd (the plain CPU version stays
    differentiable)."""
    _check_x(x)
    if x.device.type == "cpu":
        a, b = fold(scale, bias, mean, var, eps)
        _check_vectors(x, ("a", a), ("b", b))
        return fused_bn_relu_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu: unsupported device {x.device}")
    _check_vectors(x, ("scale", scale), ("bias", bias), ("mean", mean), ("var", var))
    _ext.refuse_autograd("bn_relu", x, scale, bias, mean, var)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    fn, args = launch_args(x, y, scale, bias, mean, var, eps)
    _ext.call("bn_relu", fn, x.device, *args)
    _ext.count_launch("bn_relu")
    return y
