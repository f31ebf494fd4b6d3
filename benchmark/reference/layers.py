"""Plain PyTorch layers of the frozen reference, in float32.

Nothing here imports the program under test.  Parameter and buffer names
follow the published models' state dicts (``weight``, ``bias``,
``running_mean``, ``running_var``), so one seeded weight dictionary loads
into the reference and into the program by name.

``Conv.quant`` rounds a convolution's two operands before it runs: None
(float32, the reference), ``"tf32"`` (round to nearest on TF32's 10-bit
mantissa, which is what the tensor cores do to float32 operands with TF32
on: the products are exact and the sums float32), ``"fp8"`` (float8
e4m3 with one scale a tensor, its largest magnitude mapped to 448) or
``"bf16"`` (the operands, and the output and its gradient too, as a bf16
step stores them).  The controls of the correctness check put the reference in the
program's place at one of these lower precisions; ``"bf16"``, the training
configurations' own precision, is the witness of how far that precision
alone moves each number.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32).view_as(x)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8 e4m3 at one scale for the tensor, back in float32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDING = {None: lambda t: t, "tf32": round_tf32, "fp8": round_fp8,
            "bf16": lambda t: t.to(torch.bfloat16).float()}


class _RoundBf16(torch.autograd.Function):
    """bf16 storage of an activation and of its gradient, as a bf16 step
    keeps both."""

    @staticmethod
    def forward(ctx, y):
        return y.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Conv(nn.Module):
    """A 2-D convolution (or a stride-2, kernel-2 transposed one) with
    PyTorch's parameter layout."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, transposed: bool = False):
        super().__init__()
        shape = (ci, co, k, k) if transposed else (co, ci, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None
        self.stride, self.padding, self.transposed = stride, padding, transposed
        self.quant: Optional[str] = None

    def fan_in(self) -> int:
        """PyTorch's fan-in of the weight (dim 1 times the window), which
        sets its default init bound 1/sqrt(fan_in)."""
        w = self.weight
        return w.shape[1] * w.shape[2] * w.shape[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = ROUNDING[self.quant]
        if self.transposed:
            y = F.conv_transpose2d(q(x), q(self.weight), self.bias, stride=self.stride)
        else:
            y = F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding)
        return _RoundBf16.apply(y) if self.quant == "bf16" else y


class BatchNorm(nn.Module):
    """``nn.BatchNorm2d`` semantics (momentum 0.1, eps 1e-5): batch
    statistics with the biased variance in training, the unbiased one into
    the running variance; running statistics in eval."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, 0.1, 1e-5)


class AttentionGate(nn.Module):
    """x * sigmoid(BN(1x1(relu(BN(1x1(g)) + BN(1x1(x)))))), g the decoder
    feature, x the skip (tmuird/VAEUNET ``unet/unet_parts.py:7-30``)."""

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(Conv(f_g, f_int, 1), BatchNorm(f_int))
        self.W_x = nn.Sequential(Conv(f_l, f_int, 1), BatchNorm(f_int))
        self.psi = nn.Sequential(Conv(f_int, 1, 1), BatchNorm(1), nn.Sigmoid())

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x * self.psi(F.relu(self.W_g(g) + self.W_x(x)))


def set_quant(model: nn.Module, quant: Optional[str]) -> nn.Module:
    """Every convolution of `model` rounds its operands to `quant`."""
    if quant not in ROUNDING:
        raise ValueError(f"unknown rounding {quant!r}")
    for m in model.modules():
        if isinstance(m, Conv):
            m.quant = quant
    return model
