#!/usr/bin/env python
"""Headline benchmark on the GPU: images per second of the VAE-UNet train
step.  Port of the top-level ``bench.py``:

    python -m vaeunet_tpu_torch.cli.bench

The step is ``training.step.make_train_step``'s on the flagship (resnet34,
latent 32, ``latent_injection='all'``, attention skips), at 512x512, batch
16, bf16 activations, lr 1e-4, beta 0.001, on random images and masks from
seeds: forward, Dice+BCE + beta KL, backward, clip, AdamW.  3 warm-up and
10 timed steps, each ended by a host fetch of the loss.  It prints
``bench.py``'s one JSON line::

  {"metric": "images_per_sec_per_chip_512sq_vaeunet_train", "value": N,
   "unit": "img/s", "vs_baseline": N}

where ``vs_baseline`` divides by ``torch_cpu_img_per_sec`` of
``bench_baseline.json`` (the reference's train step on the CPU, recorded
once in the repo).  The file is read, never written: a missing file is an
error.  Unlike ``bench.py`` there is no retry, no wait and no smaller batch
on a failure: a failure fails the run.  Runs on the CUDA device
(``--device cpu`` for the CPU).
"""

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

BASELINE_FILE = Path(__file__).resolve().parents[2] / "bench_baseline.json"
METRIC = "images_per_sec_per_chip_512sq_vaeunet_train"
HW = 512
BATCH = 16
STEPS = 10
WARMUP = 3


def baseline(path: Path) -> float:
    """The torch-CPU reference's img/s from `path`; raises if it is missing."""
    if not path.is_file():
        raise FileNotFoundError(f"no baseline at {path}: vs_baseline needs "
                                "bench_baseline.json, which this benchmark never writes")
    return float(json.loads(path.read_text())["torch_cpu_img_per_sec"])


def measure(batch: int = BATCH, hw: int = HW, steps: int = STEPS, warmup: int = WARMUP,
            device=None, report: Optional[dict] = None) -> float:
    """img/s of `steps` timed train steps after `warmup` ones.  `report`, a
    dict the caller passes, receives ``step_s`` (each timed step, host
    clock, ending in the loss's fetch) and ``loss`` (the timed losses)."""
    import torch

    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.training.config import TrainConfig
    from vaeunet_tpu_torch.training.state import create_train_state
    from vaeunet_tpu_torch.training.step import make_train_step

    device = resolve_device(device)
    config = TrainConfig(model_type="resnet", batch_size=batch, gradient_accumulation_steps=1,
                         amp=True, patch_size=hw, learning_rate=1e-4, seed=0)
    state = create_train_state(config, seed=0, device=device)
    step = make_train_step(config, state.model)
    images = torch.rand((batch, hw, hw, 3), generator=torch.Generator().manual_seed(1))
    masks = (torch.rand((batch, hw, hw, 1), generator=torch.Generator().manual_seed(2))
             > 0.9).float()
    images, masks = images.to(device), masks.to(device)
    beta = 0.001
    for _ in range(warmup):
        state, aux = step(state, images, masks, beta)
        aux["loss"].item()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, aux = step(state, images, masks, beta)
        losses.append(aux["loss"].item())      # the completion barrier, as bench.py's
        times.append(time.perf_counter() - t0)
    if report is not None:
        report.update(step_s=times, loss=losses)
    return batch * steps / sum(times)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="img/s of the VAE-UNet train step")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, **sizes) -> dict:
    """Prints and returns the JSON line; `sizes` (``batch``, ``hw``,
    ``steps``, ``warmup``, ``report``) go to :func:`measure`, whose defaults
    are ``bench.py``'s."""
    args = get_parser().parse_args(argv)
    base = baseline(BASELINE_FILE)
    value = measure(device=args.device, **sizes)
    line = {"metric": METRIC, "value": round(value, 3), "unit": "img/s",
            "vs_baseline": round(value / base, 2)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
