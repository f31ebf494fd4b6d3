#!/usr/bin/env python
"""Standalone evaluation on the GPU.  Port of the top-level ``evaluate.py``
(reference ``evaluate.py:20-101``), with every one of its flags, plus
``--device``:

    python -m vaeunet_tpu_torch.cli.evaluate --model RUN_DIR_OR.pth \
        --split val --scale 0.5 --patch-size 512 --data-dir DIR

``evaluate(model, loader, generator, config, max_samples)`` averages the
thresholded metric suite over batches (``training.step.make_eval_step``,
``training.loop.evaluate_model``) and collects visualization samples; the
CLI evaluates a checkpoint on a chosen split, on the CUDA device
(``--device cpu`` for the CPU).
"""

import argparse
import logging
from typing import Dict, Optional, Sequence


def evaluate(model, loader, generator, config=None, max_samples: int = 4,
             amp: bool = False, apply_sigmoid_for_metrics: bool = False, device=None):
    """-> (metrics dict averaged over batches, <= max_samples visualization
    rows).  The eval step draws its latent noise from `generator`."""
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.training.config import TrainConfig
    from vaeunet_tpu_torch.training.loop import evaluate_model
    from vaeunet_tpu_torch.training.step import make_eval_step

    config = config or TrainConfig(amp=amp)
    eval_step = make_eval_step(config, model=model,
                               apply_sigmoid_for_metrics=apply_sigmoid_for_metrics)
    return evaluate_model(eval_step, loader, generator, max_samples=max_samples,
                          device=resolve_device(device))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a checkpoint")
    parser.add_argument("--model", "-m", required=True)
    parser.add_argument("--split", default="val", choices=["train", "val", "test"])
    parser.add_argument("--lesion-type", default="EX")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--patch-size", type=lambda x: None if x.lower() == "none" else int(x),
                        default=None)
    parser.add_argument("--batch-size", type=int, default=6)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--data-dir", default="./data")
    parser.add_argument("--fixed-threshold", action="store_true",
                        help="Compute metrics on sigmoid probabilities "
                        "instead of raw logits (fixes the reference quirk, "
                        "SURVEY.md section 2.4-2)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """-> the averaged metrics."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import torch

    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.data.loader import Loader
    from vaeunet_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    model, _ = load_model(args.model, device=device)
    dataset = IDRIDDataset(args.data_dir, split=args.split, scale=args.scale,
                           patch_size=args.patch_size,
                           lesion_type=args.lesion_type,
                           max_images=args.max_images)
    loader = Loader(dataset, args.batch_size, shuffle=False, drop_last=False)
    metrics, _ = evaluate(model, loader, torch.Generator().manual_seed(args.seed),
                          apply_sigmoid_for_metrics=args.fixed_threshold, device=device)
    for k, v in metrics.items():
        logging.info("%s: %.4f", k, v)
    return metrics


if __name__ == "__main__":
    main()
