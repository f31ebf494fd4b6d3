#!/usr/bin/env python
"""Full-resolution tiled-inference latency on the GPU.  Port of
``scripts/bench_tiled.py`` (BASELINE config 4):

    python -m vaeunet_tpu_torch.cli.bench_tiled

A 1280x1918 (Carvana-sized) random image through
``inference.tiled.predict_with_patches``: 512^2 tiles at the adaptive
overlap, feathered blending, tile batch 8, z = 0, on ``UNetResNet(3, 1,
latent_dim=32)`` with random weights from a seed, in fp32 with TF32 off.
One warm-up run, then 7 timed runs, each ended by a host fetch of one
probability; it prints the p50 as one JSON line::

  {"metric": "tiled_inference_p50_latency_1918x1280", "value": ms,
   "unit": "ms", "tiles": T}

There is no retry and no fallback: a failure fails the run.  Runs on the
CUDA device (``--device cpu`` for the CPU).
"""

import argparse
import json
import sys
import time
from typing import Optional, Sequence

H, W, PATCH = 1280, 1918, 512
TILE_BATCH = 8
RUNS = 7


def measure(h: int = H, w: int = W, patch: int = PATCH, batch: int = TILE_BATCH,
            runs: int = RUNS, device=None, report: Optional[dict] = None) -> dict:
    """-> the JSON line's dict for `runs` timed tiled predictions of an
    [h, w, 3] image.  `report`, a dict the caller passes, receives
    ``latency_s`` (each timed run, host clock)."""
    import torch

    from vaeunet_tpu_torch.device import resolve_device, use_fp32_numerics
    from vaeunet_tpu_torch.inference.tiled import compute_tile_grid, predict_with_patches
    from vaeunet_tpu_torch.models.vae_unet import build_model

    device = resolve_device(device)
    use_fp32_numerics()
    model = build_model(3, 1, latent_dim=32, seed=0, device=device)
    image = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(2)).to(device)
    z = torch.zeros((1, 32), device=device)
    grid = compute_tile_grid(h, w, patch)
    print(f"{h}x{w} -> {len(grid)} tiles of {patch}^2", file=sys.stderr)

    probs = predict_with_patches(model, image, z, patch, batch_size=batch, device=device)
    float(probs[0, 0, 0])                                   # warm-up + sync
    lat = []
    for _ in range(runs):
        t0 = time.perf_counter()
        probs = predict_with_patches(model, image, z, patch, batch_size=batch, device=device)
        float(probs[0, 0, 0])
        lat.append(time.perf_counter() - t0)
    if report is not None:
        report.update(latency_s=lat)
    p50 = sorted(lat)[len(lat) // 2]
    return {"metric": f"tiled_inference_p50_latency_{w}x{h}", "value": round(p50 * 1e3, 1),
            "unit": "ms", "tiles": len(grid)}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="p50 latency of tiled full-resolution inference")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, **sizes) -> dict:
    """Prints and returns the JSON line; `sizes` (``h``, ``w``, ``patch``,
    ``batch``, ``runs``, ``report``) go to :func:`measure`, whose defaults
    are ``scripts/bench_tiled.py``'s."""
    args = get_parser().parse_args(argv)
    line = measure(device=args.device, **sizes)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
