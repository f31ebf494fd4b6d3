"""Multi-device inference: sample-parallel ensembles and the tile grid
sharded over ranks.  Port of ``vaeunet_tpu/parallel/inference.py``.

- :func:`ensemble_sample_parallel`: the N-sample ensemble of one image,
  each rank decoding N / n_data latents from the encoder features it
  computes itself (the JAX encoder output is replicated), the [N,H,W,1]
  stack gathered in sample order;
- :func:`predict_tiled_sharded`: the tile grid split over the ranks, the
  last rank's share padded by repeating the last tile (``:92-95``), each
  rank encoding and decoding its tiles in batches, the tile maps gathered
  and blended with ``inference/tiled.py``'s feather weights in grid order.

Every rank of the data group calls them with the same arguments and gets
the whole result.  Eval mode; the model on the rank's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from vaeunet_tpu_torch.device import as_image, check_serving_model
from vaeunet_tpu_torch.inference.tiled import _blend, _weights, adaptive_overlap, compute_tile_grid
from vaeunet_tpu_torch.models.vae_unet import UNetResNet
from vaeunet_tpu_torch.ops import collectives
from vaeunet_tpu_torch.parallel.mesh import ParallelContext
from vaeunet_tpu_torch.vae_utils import to_nchw


@torch.inference_mode()
def decode_samples(model: UNetResNet, image, zs: torch.Tensor, device) -> torch.Tensor:
    """[N,H,W,1] sigmoid maps of the whole image [H,W,C] for latents zs
    [N,D]: the encoder once, the decoder once a latent (JAX
    ``_decode_samples_vmapped``)."""
    image = as_image(image, device)
    h, w = image.shape[0], image.shape[1]
    _, _, features = model.encode_with_features(to_nchw(image[None]))
    zs = torch.as_tensor(zs, dtype=torch.float32, device=device)
    maps = [torch.sigmoid(model.decode_features(z[None], features, output_hw=(h, w)).float())
            for z in zs]
    return torch.cat(maps).permute(0, 2, 3, 1)


@torch.inference_mode()
def ensemble_sample_parallel(model: UNetResNet, image, zs, ctx: ParallelContext) -> torch.Tensor:
    """Full-image N-sample ensemble with the samples split over 'data'.
    zs: [N, D] with N divisible by the data axis -> [N,H,W,1] on every rank."""
    check_serving_model(model, ctx.device)
    zs = torch.as_tensor(zs, dtype=torch.float32)
    n_data = ctx.n_data
    if zs.shape[0] % n_data:
        raise ValueError(f"samples {zs.shape[0]} not divisible by data axis {n_data}")
    k = zs.shape[0] // n_data
    mine = decode_samples(model, image, zs[ctx.data_rank * k:(ctx.data_rank + 1) * k], ctx.device)
    return collectives.gather(mine.contiguous(), 0, ctx.data)


@torch.inference_mode()
def predict_tiled_sharded(model: UNetResNet, image, z, ctx: ParallelContext,
                          patch_size: int = 512, overlap: Optional[int] = None,
                          batch_size: int = 8) -> torch.Tensor:
    """Sliding-window prediction with the tile grid split over 'data':
    image [H,W,C], z [1,D] -> [H,W,1] on every rank.  Each rank runs its
    tiles `batch_size` at a time (the last batch padded with its last
    tile)."""
    check_serving_model(model, ctx.device)
    if overlap is None:
        overlap = adaptive_overlap(patch_size)
    image = as_image(image, ctx.device)
    z = torch.as_tensor(z, dtype=torch.float32, device=ctx.device).reshape(1, -1)
    h, w = image.shape[0], image.shape[1]
    grid = compute_tile_grid(h, w, patch_size, overlap)
    t = len(grid)
    padded = grid + [grid[-1]] * (-t % ctx.n_data)
    k = len(padded) // ctx.n_data
    mine = padded[ctx.data_rank * k:(ctx.data_rank + 1) * k]
    tiles = torch.stack([image[y:y + patch_size, x:x + patch_size] for (y, x) in mine])
    preds = []
    for i in range(0, k, batch_size):
        batch = tiles[i:i + batch_size]
        n = batch.shape[0]
        if n < batch_size:
            batch = torch.cat([batch, batch[-1:].expand(batch_size - n, *batch.shape[1:])])
        x = batch.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = model.encoder(x)
        logits = model.decode_features(z.expand(batch_size, -1), feats,
                                       output_hw=(patch_size, patch_size))
        preds.append(torch.sigmoid(logits.float())[:n])
    preds = collectives.gather(torch.cat(preds).contiguous(), 0, ctx.data)[:t]
    weights, wsum = _weights(h, w, grid, patch_size, overlap, ctx.device)
    return _blend(preds, weights, wsum, grid, (h, w))
