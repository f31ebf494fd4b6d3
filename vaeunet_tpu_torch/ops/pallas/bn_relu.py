"""Fused eval-mode BatchNorm + ReLU: the CUDA kernel's wrapper and its plain
version.  Port of ``vaeunet_tpu/ops/pallas/bn_relu.py``.

y = max(0, (x - mean) * rsqrt(var + eps) * scale + bias), with the affine
part folded in fp32 to ``a = scale * rsqrt(var + eps)`` and
``b = bias - mean * a`` exactly as the JAX kernel folds it.

``x`` is NCHW in ``torch.channels_last`` memory (physically NHWC, the
layout the kernel ``csrc/bn_relu.cu`` reads).  A CUDA tensor goes to the
kernel; a CPU tensor to :func:`fused_bn_relu_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vaeunet_tpu_torch.ops import _ext

_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"bn_relu expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_relu takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_relu expects a channels_last-contiguous tensor")
    c = x.shape[1]
    for name, v in (("a", a), ("b", b)):
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"bn_relu: {name} must be float32 [{c}] on {x.device}")


def fused_bn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Folded eval BN + ReLU of a channels_last NCHW tensor.  The kernel
    has no backward: on CUDA it raises under autograd (the plain CPU
    version stays differentiable)."""
    a, b = fold(scale, bias, mean, var, eps)
    _check(x, a, b)
    if x.device.type == "cpu":
        return fused_bn_relu_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu: unsupported device {x.device}")
    _ext.refuse_autograd("bn_relu", x, scale, bias, mean, var)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    fn = "vaeunet_bn_relu_f32" if x.dtype == torch.float32 else "vaeunet_bn_relu_bf16"
    _ext.call("bn_relu", fn, x.device, x.data_ptr(), a.data_ptr(), b.data_ptr(),
              y.data_ptr(), x.numel(), x.shape[1])
    _ext.count_launch("bn_relu")
    return y
