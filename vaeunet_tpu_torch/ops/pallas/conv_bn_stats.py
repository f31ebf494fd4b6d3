"""3x3 convolution with the training BatchNorm's moments: the CUDA kernel's
wrapper and its plain version.  Port of
``vaeunet_tpu/ops/pallas/conv_bn_stats.py`` (``conv3x3_bn_stats``, its
forward ``_conv3x3_stats_fwd`` and VJP ``_bwd``).

``conv3x3_bn_stats(x, weight) -> (y, s, q)``: a 3x3, pad 1, stride 1,
bias-free convolution of a channels_last NCHW ``x`` (float32 or bfloat16)
with an OIHW ``weight`` of the same type, returning y in x's type and the
per-channel fp32 sum ``s`` and sum of squares ``q`` of y over (N, H, W),
taken from the fp32 accumulator before y is rounded.  A CUDA tensor goes to
``csrc/conv_bn_stats.cu``; a CPU tensor to :func:`conv3x3_bn_stats_plain`.

On the card the bf16 forward is an implicit GEMM on the tensor cores (TMA
loads in 128-byte swizzle, ``wgmma`` from shared memory, a ring of stages
on mbarriers): M = an 8 x 16 pixel tile, N = 64 or 128 output channels,
K = 9 taps x Ci.  Its bound is the operations, 2 B H W Ci Co 9 over the
989 TFLOP/s bf16 peak.  It takes the weights K-major, [9, Co, Ci] with tap
= kx * 3 + ky (:func:`weights_k_major`), and TMA needs 16-byte strides, so
where Ci is not a multiple of 8 the wrapper zero-pads the channels of x and
w to the next one (:func:`pad_channels`); zero channels add nothing to y or
the moments.

A bf16 conv of at most ``SMALL_CI_MAX`` = 8 input channels (the plain
UNet's first, Ci = 3) takes another kernel (:func:`route`): an implicit
im2col of K = 9 x Ci, padded to a multiple of 16, on ``mma.sync``, a 4 x 64
pixel tile and 64 output channels a block, the (tile + 2) halo of the real
channels loaded once, y written as 16-byte vectors.  Its bound is the y
write, not the operations.  It reads x as it is (no padded copy) and takes
the weights [Co, K padded], k = (ky * 3 + kx) * Ci + c
(:func:`weights_small_ci`); Co must be a multiple of 8, or the conv takes
the ``wgmma`` kernel with the padding above.

fp32 (what ``TrainConfig.amp = False`` trains with, and what holds the card
against the CPU to 1e-5) is a register-tiled SIMT kernel with true fp32
FMAs, bound by the 67 TFLOP/s of the fp32 pipes: 128 threads make a tile's
128 pixels x 64 output channels, 8 columns x 8 channels a thread, from a
ring of ``F32_STAGES`` shared-memory stages that ``cp.async`` fills with
``F32_CHUNK`` input channels of the (8+2) x (16+2) patch and of the weights
while the stage before is multiplied (:func:`fp32_smem_bytes` mirrors the
layout).  It takes the weights tap-major, [9, ci_pad, co_pad] with tap =
ky * 3 + kx and zeros beyond Ci and Co (:func:`weights_tap_major`), so the
weight copies need no guard.

Each writes one row of partial moments per tile of its own (8 x 16 pixels,
4 x 64 on the Ci <= 8 route; :func:`scratch_rows`), reduced in a fixed
order.

The backward follows ``_bwd``: the moment cotangents fold into the output
cotangent, g = gy + gs + 2 y gq in fp32 (plain torch; a missing cotangent
counts as zero), cast to x's type, then the standard convolution VJPs,
which the JAX package leaves to XLA's convolutions and the port to
``torch.ops.aten.convolution_backward`` (cuDNN on the card).  Callers cast
an fp32 weight to x's type *before* the call, so autograd carries the
cast's own backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vaeunet_tpu_torch.ops import _ext

_DTYPES = (torch.float32, torch.bfloat16)
# output tile of csrc/conv_bn_stats.cu (kTH x kTW); one scratch row per tile
TILE_H, TILE_W = 8, 16
# channel multiple of the bf16 kernel's x and w: 16-byte TMA strides
CI_ALIGN = 8
# the fp32 kernel of csrc/conv_bn_stats.cu: input channels a stage, stages of
# its ring, output channels a block (kF32Chunk, kF32Stages, kF32BN)
F32_CHUNK, F32_STAGES, F32_BLOCK_CO = 8, 3, 64
# the padding of its weights: any chunk the kernel may be built with divides
# F32_CI_ALIGN; the step's channel counts are multiples of both already
F32_CI_ALIGN, F32_CO_ALIGN = 32, F32_BLOCK_CO
# the bf16 route for few input channels (conv3x3_stats_ci8_kernel): its
# largest Ci, output tile (kSTH x kSTW), the multiple of its K and of Co
SMALL_CI_MAX, SMALL_TILE_H, SMALL_TILE_W, SMALL_K_ALIGN, SMALL_CO_ALIGN = 8, 4, 64, 16, 8
# the C entries of csrc/conv_bn_stats.cu
F32_ENTRY = "vaeunet_conv3x3_stats_f32"
WGMMA_ENTRY = "vaeunet_conv3x3_stats_bf16_wgmma"
SMALL_CI_ENTRY = "vaeunet_conv3x3_stats_bf16_ci8"


def conv3x3_bn_stats_plain(x: torch.Tensor, weight: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``F.conv2d`` (pad 1), moments over (N, H, W) from the fp32
    output, y cast to x's type."""
    y32 = F.conv2d(x.float(), weight.float(), padding=1)
    s = y32.sum(dim=(0, 2, 3))
    q = (y32 * y32).sum(dim=(0, 2, 3))
    return y32.to(x.dtype).contiguous(memory_format=torch.channels_last), s, q


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3_bn_stats expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3_bn_stats takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3_bn_stats expects a channels_last-contiguous x")
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3_bn_stats: weight must be [Co, {x.shape[1]}, 3, 3], "
                         f"got {tuple(weight.shape)}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise ValueError("conv3x3_bn_stats: weight must have x's dtype and device "
                         "(cast it before the call)")


def scratch_rows(b: int, h: int, w: int, tile_h: int = TILE_H, tile_w: int = TILE_W) -> int:
    """Rows of the partial-moment scratch: one per tile_h x tile_w tile."""
    return b * (-(-h // tile_h)) * (-(-w // tile_w))


def route(ci: int, co: int, dtype: torch.dtype) -> str:
    """The C entry a conv of `ci` -> `co` channels in `dtype` takes."""
    if dtype == torch.float32:
        return F32_ENTRY
    if ci <= SMALL_CI_MAX and co % SMALL_CO_ALIGN == 0:
        return SMALL_CI_ENTRY
    return WGMMA_ENTRY


def pad_channels(x: torch.Tensor, ci: int) -> torch.Tensor:
    """A channels_last copy of x with its channels zero-padded to `ci`."""
    out = torch.empty((x.shape[0], ci, *x.shape[2:]), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[:, :x.shape[1]] = x
    out[:, x.shape[1]:] = 0
    return out


def weights_k_major(weight: torch.Tensor, ci: int) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> contiguous [9, Co, ci], tap = kx * 3 + ky,
    input channels zero-padded to `ci`."""
    co, ci0 = weight.shape[:2]
    w = weight.permute(3, 2, 0, 1)
    if ci != ci0:
        w = F.pad(w, (0, ci - ci0))
    return w.reshape(9, co, ci).contiguous()


def weights_tap_major(weight: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> contiguous [9, ci, co], tap = ky * 3 + kx, the
    output channel fastest, zeros beyond Ci and Co."""
    co0, ci0 = weight.shape[:2]
    w = weight.permute(2, 3, 1, 0).reshape(9, ci0, co0)
    if (ci, co) == (ci0, co0):
        return w.contiguous()
    out = weight.new_zeros((9, ci, co))
    out[:, :ci0, :co0] = w
    return out


def weights_small_ci(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> contiguous [Co, K], k = (ky * 3 + kx) * Ci + c,
    zeros from 9 * Ci up to K, the next multiple of SMALL_K_ALIGN."""
    co, ci = weight.shape[:2]
    w = weight.permute(0, 2, 3, 1).reshape(co, 9 * ci)
    return F.pad(w, (0, _round_up(9 * ci, SMALL_K_ALIGN) - 9 * ci)).contiguous()


def fp32_smem_bytes(chunk: int = F32_CHUNK, stages: int = F32_STAGES) -> int:
    """Shared memory of one block of the fp32 kernel, as
    ``csrc/conv_bn_stats.cu`` lays it out: per stage the (TILE_H + 2) rows
    of the patch, each (TILE_W + 2) pixels of `chunk` channels plus 4 floats
    of pitch, and the 9 x chunk x F32_BLOCK_CO weights."""
    patch = (TILE_H + 2) * ((TILE_W + 2) * chunk + 4)
    return 4 * stages * (patch + 9 * chunk * F32_BLOCK_CO)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def launch_args(x: torch.Tensor, weight: torch.Tensor, fn: Optional[str] = None):
    """The launch of :func:`route`'s kernel (or of C entry `fn`, which must
    take x's type: a benchmark's comparison), prepared: -> (C entry, its
    arguments less the stream, (y, s, q) it fills, the tensors the
    arguments point into, to be kept alive until the launch).  Few tensor
    ops, since each costs host time on every call."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    dev = x.device
    y = torch.empty((b, co, h, w), dtype=x.dtype, device=dev, memory_format=torch.channels_last)
    fn = fn or route(ci, co, x.dtype)
    tile = (TILE_H, TILE_W)
    if fn == SMALL_CI_ENTRY:
        xk, wk, dims, tile = x, weights_small_ci(weight), (ci, co), (SMALL_TILE_H, SMALL_TILE_W)
    elif fn == WGMMA_ENTRY:
        ci_k = _round_up(ci, CI_ALIGN)
        xk = x if ci_k == ci and x.data_ptr() % 16 == 0 else pad_channels(x, ci_k)
        wk, dims = weights_k_major(weight, ci_k), (ci_k, co)
    else:
        xk = x
        pads = (_round_up(ci, F32_CI_ALIGN), _round_up(co, F32_CO_ALIGN))
        wk, dims = weights_tap_major(weight, *pads), (ci, co, *pads)
    tiles = scratch_rows(b, h, w, *tile)
    # s, q and the two [tiles, Co] scratch halves in one allocation; the
    # reduce kernel writes every element of s and q
    buf = torch.empty(2 * (tiles + 1) * co, dtype=torch.float32, device=dev)
    s, q = buf[:co], buf[co:2 * co]
    p = buf.data_ptr() + 8 * co
    args = (xk.data_ptr(), wk.data_ptr(), y.data_ptr(), p, p + 4 * tiles * co, s.data_ptr(),
            q.data_ptr(), b, h, w, *dims, tiles)
    return fn, args, (y, s, q), (xk, wk, buf)


def _forward_cuda(x: torch.Tensor, weight: torch.Tensor):
    b, _, h, w = x.shape
    co = weight.shape[0]
    if b * co * h * w == 0:
        y = torch.empty((b, co, h, w), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        return y, torch.zeros(co, device=x.device), torch.zeros(co, device=x.device)
    fn, args, out, _ = launch_args(x, weight)
    _ext.call("conv_bn_stats", fn, x.device, *args)
    if fn == SMALL_CI_ENTRY:
        _ext.count_launch("conv_bn_stats_ci8")
    else:
        _ext.count_launch("conv_bn_stats")
        if fn == F32_ENTRY:
            _ext.count_launch("conv_bn_stats_fp32")
    return out


def fold_cotangents(y: torch.Tensor, gy, gs, gq, dtype: torch.dtype) -> torch.Tensor:
    """g = gy + gs + 2 y gq per channel, in fp32, cast to `dtype`
    (``conv_bn_stats.py:130-134``); None stands for a zero cotangent."""
    g = torch.zeros_like(y, dtype=torch.float32) if gy is None else gy.float()
    if gs is not None:
        g = g + gs.view(1, -1, 1, 1)
    if gq is not None:
        g = g + 2.0 * y.float() * gq.view(1, -1, 1, 1)
    return g.to(dtype).contiguous(memory_format=torch.channels_last)


class _Conv3x3BnStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, s, q = conv3x3_bn_stats_plain(x, weight)
        elif x.device.type == "cuda":
            y, s, q = _forward_cuda(x, weight)
        else:
            raise ValueError(f"conv3x3_bn_stats: unsupported device {x.device}")
        ctx.save_for_backward(x, weight, y)
        return y, s, q

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gs, gq):
        x, weight, y = ctx.saved_tensors
        if gy is None and gs is None and gq is None:
            return None, None
        g = fold_cotangents(y, gy, gs, gq, x.dtype)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw


def conv3x3_bn_stats(x: torch.Tensor, weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, s, q) of a 3x3 pad-1 stride-1 bias-free convolution; see the
    module docstring.  Differentiable in x and weight through all three."""
    _check(x, weight)
    return _Conv3x3BnStats.apply(x, weight)
