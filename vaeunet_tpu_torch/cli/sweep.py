#!/usr/bin/env python
"""Offline hyperparameter sweep on the GPU.  Port of ``scripts/run_sweep.py``,
with every one of its flags, dests and defaults, plus ``--device``:

    python -m vaeunet_tpu_torch.cli.sweep --trials 10 --data-dir DIR \
        --max-epochs 5

Random search over ``sweep.yaml``'s space without a W&B server: each trial
draws a config from ``SPACE`` (``sample_config`` on ``random.Random(--seed)``,
so the port's trials are the script's, one for one), trains it with
``training.loop.train_model`` and a ``utils.tracking.Tracker`` in
``./runs/sweep_<i>``, reads the best ``val/dice`` of the run's
``metrics.jsonl``, and appends a record with the script's keys to --out.
A trial that raises is recorded with ``status: "error: ..."``, as the script
does, and the sweep goes on.  Runs on the CUDA device (``--device cpu`` for
the CPU).
"""

import argparse
import json
import logging
import math
import random
import time
from typing import Optional, Sequence

SPACE = {
    "batch_size": [2, 4, 6, 8],
    "epochs": [50, 100, 150],
    "scale": [0.25, 0.5, 1.0],
    "learning_rate": ("log_uniform", 1e-5, 1e-3),
    "patch_size": [256, 512, None],
    "free_bits": ("log_uniform", 1e-4, 1.0),
    "kl_anneal_epochs": [10, 20, 40],
}


def sample_config(rng: random.Random) -> dict:
    out = {}
    for k, spec in SPACE.items():
        if isinstance(spec, tuple) and spec[0] == "log_uniform":
            lo, hi = math.log(spec[1]), math.log(spec[2])
            out[k] = math.exp(rng.uniform(lo, hi))
        else:
            out[k] = rng.choice(spec)
    return out


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--data-dir", default="./data")
    parser.add_argument("--lesion-type", default="EX")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="Cap epochs per trial (short sweeps)")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="sweep_results.jsonl")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> list:
    """-> the trials' records, best validation Dice first."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.training.config import TrainConfig
    from vaeunet_tpu_torch.training.loop import train_model
    from vaeunet_tpu_torch.utils.tracking import Tracker

    device = resolve_device(args.device)
    rng = random.Random(args.seed)
    results = []
    for trial in range(args.trials):
        hp = sample_config(rng)
        if args.max_epochs:
            hp["epochs"] = min(hp["epochs"], args.max_epochs)
        logging.info("Trial %d/%d: %s", trial + 1, args.trials, hp)
        config = TrainConfig(
            data_dir=args.data_dir, lesion_type=args.lesion_type,
            batch_size=hp["batch_size"], epochs=hp["epochs"],
            img_scale=hp["scale"], learning_rate=hp["learning_rate"],
            patch_size=hp["patch_size"], free_bits=hp["free_bits"],
            kl_anneal_epochs=hp["kl_anneal_epochs"],
            max_images=args.max_images, seed=args.seed + trial,
            checkpoint_dir=f"./checkpoints/sweep_{trial}")
        tracker = Tracker(run_dir=f"./runs/sweep_{trial}",
                          config={**hp, "trial": trial})
        t0 = time.time()
        try:
            train_model(config, tracker=tracker, device=device)
            metrics_file = tracker.run_dir / "metrics.jsonl"
            best_dice = max(
                (json.loads(l).get("val/dice", 0.0)
                 for l in metrics_file.read_text().splitlines()
                 if "val/dice" in l), default=0.0)
            status = "ok"
        except Exception as e:      # noqa: BLE001 - the script records any failure
            logging.error("Trial %d failed: %s", trial, e)
            best_dice, status = 0.0, f"error: {e}"
        rec = {"trial": trial, **hp, "best_val_dice": best_dice,
               "status": status, "seconds": round(time.time() - t0, 1)}
        results.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    results.sort(key=lambda r: -r["best_val_dice"])
    logging.info("Best trial: %s", results[0] if results else None)
    return results


if __name__ == "__main__":
    main()
