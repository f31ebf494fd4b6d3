"""Tiled sliding-window inference with feathered blending.  Port of
``vaeunet_tpu/inference/tiled.py`` (reference ``visualize_vae.py:243-476``).

- the tile grid is static (adaptive overlap ``clamp(0.2*P, 32, 128)``,
  edge-clamped last row/col), so every tile is [P, P];
- tiles run through the network in fixed batches, the last one padded by
  repeating the last tile;
- the encoder runs once per tile; the decoder runs once per tile batch and
  sample, with the tile features kept on the device;
- predictions are blended into [H, W, 1] in fp32 with the linear-ramp
  feather weights, tile by tile in grid order.

Images are NHWC ([H, W, C]) at these functions and maps come back
[H, W, 1] / [N, H, W, 1]; the model runs NCHW channels_last.

A request records its stages as spans (``utils/profiling.py``; only while a
``torch.profiler`` session runs): ``serve.tiled`` around the request, inside
it ``serve.tiles`` (cut, stack, pad, layout), ``serve.encode``,
``serve.weights``, then ``serve.decode`` and ``serve.blend`` once a sample.
``encode_tiles`` counts the grid's tiles and the encoder slots they take,
padding included (``ops/_ext.py``'s ``tiles`` and ``tile_slots``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.device import as_image, check_serving_model, resolve_device
from vaeunet_tpu_torch.models.vae_unet import UNetResNet
from vaeunet_tpu_torch.ops._ext import LAUNCHES
from vaeunet_tpu_torch.utils.profiling import span


def adaptive_overlap(patch_size: int) -> int:
    """clamp(0.2 * patch, 32, 128)  (visualize_vae.py:250-251)."""
    return max(min(int(patch_size * 0.2), 128), 32)


def compute_tile_grid(h: int, w: int, patch_size: int,
                      overlap: Optional[int] = None) -> List[Tuple[int, int]]:
    """Static (y, x) tile origins; last row/col clamped to the image edge
    (visualize_vae.py:253-288).  Requires h, w >= patch_size."""
    if overlap is None:
        overlap = adaptive_overlap(patch_size)
    if h < patch_size or w < patch_size:
        raise ValueError(f"image {h}x{w} smaller than patch {patch_size}")
    stride = patch_size - overlap
    n_h = math.ceil((h - overlap) / stride)
    n_w = math.ceil((w - overlap) / stride)
    grid = []
    for i in range(n_h):
        for j in range(n_w):
            y = (h - patch_size) if i == n_h - 1 else i * stride
            x = (w - patch_size) if j == n_w - 1 else j * stride
            grid.append((y, x))
    return grid


def tile_weight_masks(h: int, w: int, patch_size: int,
                      overlap: Optional[int] = None) -> np.ndarray:
    """[T, P, P, 1] feather weights: linspace(0,1,overlap) ramps on interior
    edges, exactly the reference's blending (visualize_vae.py:361-378)."""
    if overlap is None:
        overlap = adaptive_overlap(patch_size)
    stride = patch_size - overlap
    n_h = math.ceil((h - overlap) / stride)
    n_w = math.ceil((w - overlap) / stride)
    ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
    masks = []
    for i in range(n_h):
        for j in range(n_w):
            wgt = np.ones((patch_size, patch_size), np.float32)
            if patch_size > 2 * overlap:
                if i > 0:
                    wgt[:overlap, :] *= ramp[:, None]
                if i < n_h - 1:
                    wgt[-overlap:, :] *= (1.0 - ramp)[:, None]
                if j > 0:
                    wgt[:, :overlap] *= ramp[None, :]
                if j < n_w - 1:
                    wgt[:, -overlap:] *= (1.0 - ramp)[None, :]
            masks.append(wgt)
    return np.stack(masks)[..., None]


def encode_tiles(model: UNetResNet, image: torch.Tensor, patch_size: int,
                 overlap: Optional[int] = None, batch_size: int = 8):
    """Encoder features of every tile of `image` [H,W,C].

    -> (grid, features): features[k] is a list of 5 maps for tile batch k,
    each [batch_size, C_i, h_i, w_i]; the last batch is padded by repeating
    the last tile (the JAX package's static batching).
    """
    h, w = image.shape[0], image.shape[1]
    with span("serve.tiles"):
        grid = compute_tile_grid(h, w, patch_size, overlap)
        tiles = torch.stack([image[y:y + patch_size, x:x + patch_size] for (y, x) in grid])
        pad = -len(grid) % batch_size
        if pad:
            tiles = torch.cat([tiles, tiles[-1:].expand(pad, *tiles.shape[1:])])
        tiles = tiles.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    LAUNCHES["tiles"] += len(grid)
    LAUNCHES["tile_slots"] += tiles.shape[0]
    with span("serve.encode"):
        batches = [model.encoder(tiles[k:k + batch_size])
                   for k in range(0, tiles.shape[0], batch_size)]
    return grid, batches


def _decode_tiles(model: UNetResNet, batches, z: torch.Tensor, patch_size: int,
                  n_tiles: int) -> torch.Tensor:
    """Decode every tile with the shared latent z [1, D] -> sigmoid
    [T, 1, P, P] fp32 (visualize_vae.py:322-345)."""
    with span("serve.decode"):
        preds = []
        for feats in batches:
            zb = z.expand(feats[0].shape[0], z.shape[-1])
            logits = model.decode_features(zb, feats, output_hw=(patch_size, patch_size))
            preds.append(torch.sigmoid(logits.float()))
        return torch.cat(preds)[:n_tiles]


def _blend(preds: torch.Tensor, weights: torch.Tensor, wsum: torch.Tensor,
           grid, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Weighted add of [T,C,P,P] tiles in grid order into [H,W,C], divided
    by the weight sum.  (visualize_vae.py:383-384,409)"""
    with span("serve.blend"):
        h, w = out_hw
        p = preds.shape[-1]
        out = torch.zeros((preds.shape[1], h, w), dtype=torch.float32, device=preds.device)
        for t, (y, x) in enumerate(grid):
            out[:, y:y + p, x:x + p] += preds[t] * weights[t]
        return (out / (wsum + 1e-8)).permute(1, 2, 0)


def _weights(h: int, w: int, grid, patch_size: int, overlap: int, device):
    """-> (weights [T,1,P,P], weight sum [1,H,W]) in fp32, summed in grid order."""
    with span("serve.weights"):
        weights = torch.from_numpy(tile_weight_masks(h, w, patch_size, overlap)).to(device)
        weights = weights.permute(0, 3, 1, 2)
        wsum = torch.zeros((1, h, w), dtype=torch.float32, device=device)
        for t, (y, x) in enumerate(grid):
            wsum[:, y:y + patch_size, x:x + patch_size] += weights[t]
        return weights, wsum


@torch.inference_mode()
def predict_tiled_ensemble(model: UNetResNet, image, zs: torch.Tensor,
                           patch_size: int = 512, overlap: Optional[int] = None,
                           batch_size: int = 8, device=None) -> torch.Tensor:
    """[N,H,W,1] sigmoid maps of one image [H,W,C] for N latents zs [N,D]:
    the tile encoder runs once, the decoder once per sample."""
    with span("serve.tiled"):
        device = resolve_device(device)
        check_serving_model(model, device)
        if overlap is None:
            overlap = adaptive_overlap(patch_size)
        image = as_image(image, device)
        zs = torch.as_tensor(zs, dtype=torch.float32, device=device)
        h, w = image.shape[0], image.shape[1]
        grid, batches = encode_tiles(model, image, patch_size, overlap, batch_size)
        weights, wsum = _weights(h, w, grid, patch_size, overlap, device)
        maps = []
        for z in zs:
            preds = _decode_tiles(model, batches, z[None], patch_size, len(grid))
            maps.append(_blend(preds, weights, wsum, grid, (h, w)))
        return torch.stack(maps)


def predict_with_patches(model: UNetResNet, image, z: torch.Tensor, patch_size: int = 512,
                         overlap: Optional[int] = None, batch_size: int = 8,
                         device=None) -> torch.Tensor:
    """Tiled sigmoid probability map [H,W,1] for one image [H,W,C] and one
    latent z [1,D].  (visualize_vae.py:243-415)"""
    return predict_tiled_ensemble(model, image, z, patch_size, overlap, batch_size,
                                  device=device)[0]
