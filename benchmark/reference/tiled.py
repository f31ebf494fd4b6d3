"""Tiled full-resolution serving in plain PyTorch, float32: tmuird/VAEUNET
``visualize_vae.py`` (the tile grid and feathered blending of
``predict_with_patches``, :243-415; the N-sample distribution, :578-652;
the uncertainty maps, :90-117).

- tiles of P x P at stride P - overlap, the last row and column clamped to
  the image's edge; the adaptive overlap is clamp(0.2 P, 32, 128);
- each tile's weight is 1, times a linear ramp 0 -> 1 over `overlap`
  pixels on each edge that has a neighbour (when P > 2 overlap); the
  blended map is sum(w p) / (sum(w) + 1e-8);
- the latents: the encoder on the whole image gives mu and logvar, logvar
  is clamped to +-2 for sampling, z_i = mu + eps_i exp(logvar / 2) T;
- each tile is encoded once and decoded with each z_i; the probabilities
  are the sigmoid of the logits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

LOGVAR_GUARD = 2.0


def adaptive_overlap(patch: int) -> int:
    return max(min(int(patch * 0.2), 128), 32)


def tile_grid(h: int, w: int, patch: int, overlap: int) -> Tuple[List[Tuple[int, int]], int, int]:
    """-> (tile origins row by row, rows, columns)."""
    stride = patch - overlap
    rows = math.ceil((h - overlap) / stride)
    cols = math.ceil((w - overlap) / stride)
    grid = [(h - patch if i == rows - 1 else i * stride, w - patch if j == cols - 1 else j * stride)
            for i in range(rows) for j in range(cols)]
    return grid, rows, cols


def tile_weights(rows: int, cols: int, patch: int, overlap: int, device) -> torch.Tensor:
    """[rows * cols, P, P] feather weights."""
    ramp = torch.linspace(0, 1, overlap, device=device)
    out = torch.ones((rows * cols, patch, patch), device=device)
    if patch <= 2 * overlap:
        return out
    for i in range(rows):
        for j in range(cols):
            t = out[i * cols + j]
            if i > 0:
                t[:overlap] *= ramp[:, None]
            if i < rows - 1:
                t[-overlap:] *= (1 - ramp)[:, None]
            if j > 0:
                t[:, :overlap] *= ramp[None, :]
            if j < cols - 1:
                t[:, -overlap:] *= (1 - ramp)[None, :]
    return out


def tiled_probabilities(model, image: torch.Tensor, zs: torch.Tensor, patch: int,
                        overlap: int, batch: int) -> torch.Tensor:
    """[N, H, W] blended probabilities of image [H, W, 3] for latents zs
    [N, D] (the VAE-UNet)."""
    h, w = image.shape[:2]
    grid, rows, cols = tile_grid(h, w, patch, overlap)
    weights = tile_weights(rows, cols, patch, overlap, image.device)
    wsum = torch.zeros((h, w), device=image.device)
    for (y, x), wt in zip(grid, weights):
        wsum[y:y + patch, x:x + patch] += wt
    tiles = torch.stack([image[y:y + patch, x:x + patch] for y, x in grid]).permute(0, 3, 1, 2)
    feats = [model.encoder(tiles[k:k + batch]) for k in range(0, len(grid), batch)]
    out = torch.zeros((zs.shape[0], h, w), device=image.device)
    for n, z in enumerate(zs):
        k = 0
        for f in feats:
            logits = model.decode(z[None].expand(f[0].shape[0], -1), f, (patch, patch))
            for p in torch.sigmoid(logits[:, 0]):
                y, x = grid[k]
                out[n, y:y + patch, x:x + patch] += p * weights[k]
                k += 1
    return out / (wsum + 1e-8)


def uncertainty_maps(samples: torch.Tensor, eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """samples [N, ...] -> mean, population std, entropy of the mean, and
    mutual information (entropy minus the mean entropy of the samples)."""
    def entropy(p):
        p = torch.clamp(p, eps, 1 - eps)
        return -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    mean = samples.mean(0)
    ent = entropy(mean)
    return {"mean": mean, "std": samples.std(0, correction=0), "entropy": ent,
            "mutual_info": ent - entropy(samples).mean(0)}


@torch.no_grad()
def uq_request(model, image: torch.Tensor, eps: torch.Tensor, patch: int,
               overlap: Optional[int], batch: int, temperature: float = 1.0):
    """-> (samples [N, H, W], maps) for image [H, W, 3] and noise eps [N, D]."""
    model.eval()
    overlap = adaptive_overlap(patch) if overlap is None else overlap
    mu, logvar = model.heads(model.encoder(image.permute(2, 0, 1)[None])[-1])
    std = torch.exp(0.5 * torch.clamp(logvar, -LOGVAR_GUARD, LOGVAR_GUARD)) * temperature
    zs = mu + eps * std
    samples = tiled_probabilities(model, image, zs, patch, overlap, batch)
    return samples, uncertainty_maps(samples)


@torch.no_grad()
def predict(model, image: torch.Tensor, z: torch.Tensor, patch: int, overlap: Optional[int],
            batch: int) -> torch.Tensor:
    """[H, W] blended probabilities of image [H, W, 3] for one latent z [D]."""
    model.eval()
    overlap = adaptive_overlap(patch) if overlap is None else overlap
    return tiled_probabilities(model, image, z[None], patch, overlap, batch)[0]
