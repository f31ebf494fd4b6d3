"""Bilinear resize along H and W and its gradient: the CUDA kernels'
wrappers and their plain versions.  Port of
``vaeunet_tpu/ops/pallas/resize_mm.py`` (``resize_h`` and ``resize_w``, and
their VJP ``_make_op`` / ``resize_h_op`` / ``resize_w_op``).

The JAX kernels contract one axis with the dense [out, in] interpolation
matrix.  Its rows have two nonzeros, (1 - lambda) at i0 and lambda at i1, so
the port keeps the per-axis tables instead and ``csrc/resize.cu`` blends the
four neighbours of both axes in one pass.  The tables come from
:func:`_source_coords`, a copy of ``vaeunet_tpu/ops/resize.py``'s fp32
coordinate rule, so the port and the JAX package interpolate from the same
coordinates.  ``x`` is NCHW in ``torch.channels_last`` memory.

On CUDA the forward is a ``torch.autograd.Function`` whose backward is the
second kernel, gx = M^T g, a gather over the transposed tables of
:func:`transpose_table`.  On the CPU the plain forward is differentiable by
itself, and :func:`resize_backward_plain` spells out the same gradient.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

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
    # cached tables outlive the call: never make them inference tensors,
    # which a later training step could not save for backward
    with torch.inference_mode(False):
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


def transpose_table(in_size: int, out_size: int, align_corners: bool
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The transpose of one axis's interpolation, in CSR form: (ptr int32
    [in_size + 1], out index int32 [nnz], weight float32 [nnz]).  Input i's
    pairs are ``[ptr[i], ptr[i + 1])``: first those where i is an output's
    i0 (weight 1 - lambda), then those where it is its i1 (weight lambda),
    each in ascending output order -- the order in which the plain
    version's two ``index_add_`` passes add them."""
    i0, i1, lam = axis_table(in_size, out_size, align_corners)
    src = np.concatenate([i0, i1])
    outs = np.tile(np.arange(out_size, dtype=np.int32), 2)
    wts = np.concatenate([np.float32(1.0) - lam, lam]).astype(np.float32)
    order = np.argsort(src, kind="stable")
    ptr = np.zeros(in_size + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=in_size), out=ptr[1:])
    return ptr, outs[order].astype(np.int32), wts[order]


@functools.lru_cache(maxsize=256)
def _device_transpose_table(in_size: int, out_size: int, align_corners: bool, device: str):
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in
                     transpose_table(in_size, out_size, align_corners))


def _scatter_axis(g: torch.Tensor, dim: int, in_size: int, align_corners: bool) -> torch.Tensor:
    """The transpose of :func:`_lerp_axis` along `dim`."""
    out_size = g.shape[dim]
    if in_size == out_size:
        return g
    i0, i1, lam = _device_table(in_size, out_size, align_corners, str(g.device))
    shape = [1] * g.dim()
    shape[dim] = out_size
    lam = lam.view(shape)
    out_shape = list(g.shape)
    out_shape[dim] = in_size
    out = g.new_zeros(out_shape)
    out.index_add_(dim, i0, (1.0 - lam) * g)
    out.index_add_(dim, i1, lam * g)
    return out


def resize_backward_plain(g: torch.Tensor, in_hw: Tuple[int, int],
                          align_corners: bool) -> torch.Tensor:
    """gx = M^T g of :func:`resize_plain`, in fp32, cast back to g's dtype.

    The reverse of the forward's order: H^T first, then W^T, each as two
    ``index_add_`` passes (the i0 pairs, then the i1 pairs).  On the CPU
    ``index_add_`` adds in index order, the order the kernel sums in, so the
    two agree bit for bit; on CUDA ``index_add_`` adds with atomics in no
    fixed order, and the two agree to fp32 rounding (the tolerance in
    ``chip_smoke.py`` is 1e-6 of the sum of the terms' magnitudes)."""
    t = _scatter_axis(g.float(), 2, int(in_hw[0]), align_corners)
    gx = _scatter_axis(t, 3, int(in_hw[1]), align_corners)
    return gx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"resize expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resize takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("resize expects a channels_last-contiguous tensor")


def _suffix(t: torch.Tensor) -> str:
    return "f32" if t.dtype == torch.float32 else "bf16"


def _resize_cuda(x: torch.Tensor, oh: int, ow: int, align_corners: bool) -> torch.Tensor:
    b, c, h, w = x.shape
    y = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    h0, h1, lh = _device_table(h, oh, align_corners, str(x.device))
    w0, w1, lw = _device_table(w, ow, align_corners, str(x.device))
    _ext.call("resize", f"vaeunet_resize_{_suffix(x)}", x.device, x.data_ptr(), y.data_ptr(),
              h0.data_ptr(), h1.data_ptr(), lh.data_ptr(),
              w0.data_ptr(), w1.data_ptr(), lw.data_ptr(), b, h, w, c, oh, ow)
    _ext.count_launch("resize")
    return y


def resize_backward(g: torch.Tensor, in_hw: Tuple[int, int],
                    align_corners: bool) -> torch.Tensor:
    """Gradient of :func:`resize` with respect to its input: gx [B, C, H, W]
    channels_last from g [B, C, OH, OW] (any memory layout; it is made
    channels_last here, as autograd may hand over an NCHW-contiguous g)."""
    if g.dim() != 4:
        raise ValueError(f"resize_backward expects NCHW, got shape {tuple(g.shape)}")
    g = g.contiguous(memory_format=torch.channels_last)
    _check(g)
    if g.device.type == "cpu":
        return resize_backward_plain(g, in_hw, align_corners)
    if g.device.type != "cuda":
        raise ValueError(f"resize_backward: unsupported device {g.device}")
    b, c, oh, ow = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    gx = torch.empty((b, c, h, w), dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    if gx.numel() == 0:
        return gx
    hp, hi, hw = _device_transpose_table(h, oh, align_corners, str(g.device))
    wp, wi, ww = _device_transpose_table(w, ow, align_corners, str(g.device))
    _ext.call("resize", f"vaeunet_resize_bwd_{_suffix(g)}", g.device, g.data_ptr(),
              gx.data_ptr(), hp.data_ptr(), hi.data_ptr(), hw.data_ptr(),
              wp.data_ptr(), wi.data_ptr(), ww.data_ptr(), b, h, w, c, oh, ow)
    _ext.count_launch("resize_bwd")
    return gx


class _ResizeCuda(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, oh, ow, align_corners):
        ctx.in_hw = (x.shape[2], x.shape[3])
        ctx.align_corners = align_corners
        return _resize_cuda(x, oh, ow, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return resize_backward(g, ctx.in_hw, ctx.align_corners), None, None, None


def resize(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of a channels_last NCHW tensor to `out_hw`;
    differentiable with respect to `x` on both devices."""
    _check(x)
    b, c, h, w = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    if x.device.type == "cpu":
        return resize_plain(x, (oh, ow), align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"resize: unsupported device {x.device}")
    return _ResizeCuda.apply(x, oh, ow, align_corners)


def resize_h(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along H only (the JAX ``resize_h``): W keeps its size."""
    return resize(x, (out_size, x.shape[3]), align_corners)


def resize_w(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along W only (the JAX ``resize_w``): H keeps its size."""
    return resize(x, (x.shape[2], out_size), align_corners)
