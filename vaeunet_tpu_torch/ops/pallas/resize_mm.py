"""Bilinear resize along H and W: the CUDA kernel's wrapper and its plain
version.  Port of ``vaeunet_tpu/ops/pallas/resize_mm.py`` (``resize_h`` and
``resize_w``, forward; their VJP belongs to the training slice).

The JAX kernels contract one axis with the dense [out, in] interpolation
matrix.  Its rows have two nonzeros, (1 - lambda) at i0 and lambda at i1, so
the port keeps the per-axis tables instead and ``csrc/resize.cu`` blends the
four neighbours of both axes in one pass.  The tables come from
:func:`_source_coords`, a copy of ``vaeunet_tpu/ops/resize.py``'s fp32
coordinate rule, so the port and the JAX package interpolate from the same
coordinates.  ``x`` is NCHW in ``torch.channels_last`` memory.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.ops import _ext

_DTYPES = (torch.float32, torch.bfloat16)


def _source_coords(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Source coordinates in float32, matching PyTorch's upsample kernels
    (copy of ``vaeunet_tpu/ops/resize.py::_source_coords``)."""
    if align_corners:
        if out_size == 1:
            return np.zeros((1,), dtype=np.float32)
        scale = np.float32(in_size - 1) / np.float32(out_size - 1)
        return np.arange(out_size, dtype=np.float32) * scale
    scale = np.float32(in_size) / np.float32(out_size)
    coords = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    return np.maximum(coords, np.float32(0.0))


def axis_table(in_size: int, out_size: int, align_corners: bool
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, lambda) for one axis: int32, int32, float32 of length
    out_size.  An axis kept at its size gets the identity table."""
    if in_size == out_size:
        k = np.arange(out_size, dtype=np.int32)
        return k, k.copy(), np.zeros(out_size, np.float32)
    coords = _source_coords(in_size, out_size, align_corners)
    i0 = np.clip(np.floor(coords).astype(np.int32), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1).astype(np.int32)
    lam = (coords - i0).astype(np.float32)
    return i0, i1, lam


@functools.lru_cache(maxsize=256)
def _device_table(in_size: int, out_size: int, align_corners: bool, device: str):
    return tuple(torch.from_numpy(t).to(device) for t in
                 axis_table(in_size, out_size, align_corners))


def _lerp_axis(x: torch.Tensor, dim: int, out_size: int, align_corners: bool) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    i0, i1, lam = _device_table(in_size, out_size, align_corners, str(x.device))
    shape = [1] * x.dim()
    shape[dim] = out_size
    lam = lam.view(shape)
    lo = x.index_select(dim, i0)
    hi = x.index_select(dim, i1)
    return (1.0 - lam) * lo + lam * hi


def resize_plain(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """W first, then H, in fp32 (the JAX CPU path's order), cast back."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    y = _lerp_axis(x.float(), 3, ow, align_corners)
    y = _lerp_axis(y, 2, oh, align_corners)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"resize expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resize takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("resize expects a channels_last-contiguous tensor")


def resize(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of a channels_last NCHW tensor to `out_hw`."""
    _check(x)
    b, c, h, w = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    if x.device.type == "cpu":
        return resize_plain(x, (oh, ow), align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"resize: unsupported device {x.device}")
    y = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    h0, h1, lh = _device_table(h, oh, align_corners, str(x.device))
    w0, w1, lw = _device_table(w, ow, align_corners, str(x.device))
    fn = "vaeunet_resize_f32" if x.dtype == torch.float32 else "vaeunet_resize_bf16"
    _ext.call("resize", fn, x.device, x.data_ptr(), y.data_ptr(),
              h0.data_ptr(), h1.data_ptr(), lh.data_ptr(),
              w0.data_ptr(), w1.data_ptr(), lw.data_ptr(), b, h, w, c, oh, ow)
    _ext.count_launch("resize")
    return y


def resize_h(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along H only (the JAX ``resize_h``): W keeps its size."""
    return resize(x, (out_size, x.shape[3]), align_corners)


def resize_w(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along W only (the JAX ``resize_w``): H keeps its size."""
    return resize(x, (x.shape[2], out_size), align_corners)
