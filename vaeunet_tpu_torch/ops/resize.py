"""Bilinear / nearest resize with PyTorch semantics.  Port of
``vaeunet_tpu/ops/resize.py``.

Tensors are NCHW in ``torch.channels_last`` memory.  Bilinear resizes of
either ``align_corners`` convention go through the CUDA kernel of
``ops/pallas/resize_mm.py`` (its plain version on the CPU); the JAX
package's TPU lowerings (interp-matrix einsums, banded 2x forms) have no
counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.ops.pallas.resize_mm import resize


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of H, W; matches ``F.interpolate(mode='bilinear')``
    for both conventions, blending W before H."""
    return resize(x, out_hw, align_corners)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize matching ``F.interpolate(mode='nearest')``:
    src = floor(dst * in/out)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2], x.shape[-1]

    def idx(in_size, out_size):
        src = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size))
        return torch.from_numpy(np.clip(src, 0, in_size - 1).astype(np.int64)).to(x.device)

    if ow != w:
        x = x.index_select(x.dim() - 1, idx(w, ow))
    if oh != h:
        x = x.index_select(x.dim() - 2, idx(h, oh))
    return x


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``."""
    h, w = x.shape[-2], x.shape[-1]
    return resize_bilinear(x, (2 * h, 2 * w), align_corners=True)


def broadcast_latent_spatial(z: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, D] latent -> [B, D, H, W] channels_last.  Interpolating a 1x1
    map, as the reference does, is a broadcast."""
    b, d = z.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    return z[:, :, None, None].expand(b, d, oh, ow).contiguous(
        memory_format=torch.channels_last)
