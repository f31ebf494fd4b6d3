#!/usr/bin/env python
"""Visualize VAE-UNet uncertainty on the GPU.  Port of the top-level
``visualize_vae.py`` (reference ``visualize_vae.py:1213-1452``), with every
one of its flags under the same ``dest``, plus ``--device``:

    python -m vaeunet_tpu_torch.cli.visualize --model RUN_DIR_OR.pth \
        --patch_size 512 --compare_temperatures --ensemble --data-dir DIR

Walks the unique test images and writes a 3x3 uncertainty panel per image
to ``<output_dir>/<model>/<lesion>/<p{size}|full>/T{t}/N{n}/<img>_<timestamp>.png``,
with optional multi-temperature comparison (``_temps.png``) and weighted
temperature ensembling (``_ensemble.png``), on the CUDA device
(``--device cpu`` for the CPU).
"""

import argparse
import datetime
import logging
from pathlib import Path
from typing import List, Optional, Sequence


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Visualize VAE-UNet predictions")
    parser.add_argument("--model", "-m", default="best_model.pth", metavar="FILE")
    parser.add_argument("--lesion_type", type=str, default="EX",
                        choices=["EX", "HE", "MA", "SE", "OD"])
    parser.add_argument("--samples", "-n", type=int, default=5,
                        help="Number of latent samples per image")
    parser.add_argument("--temperature", "-t", type=float, default=1.0)
    parser.add_argument("--patch_size", "-p", type=int, default=None)
    parser.add_argument("--overlap", type=int, default=100)
    parser.add_argument("--scale", "-s", type=float, default=1.0)
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--skip_border_check", action="store_true", default=True)
    parser.add_argument("--compare_temperatures", action="store_true",
                        help="Also render per-temperature mean/std rows")
    parser.add_argument("--ensemble", action="store_true",
                        help="Also render the weighted multi-T ensemble")
    parser.add_argument("--temperatures", type=float, nargs="+",
                        default=[0.5, 1.0, 2.0, 3.0])
    parser.add_argument("--unweighted", dest="weighted", action="store_false",
                        default=True)
    parser.add_argument("--latent-injection", type=str, default="all",
                        choices=["all", "first", "last", "bottleneck",
                                 "inject_no_bottleneck", "none"])
    parser.add_argument("--attention", dest="use_attention",
                        action="store_true", default=True)
    parser.add_argument("--no-attention", dest="use_attention",
                        action="store_false")
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
    """-> the PNG files written."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import torch

    from vaeunet_tpu_torch.analysis.visualize import (generate_and_compare_ensemble,
                                                      plot_reconstruction,
                                                      visualize_temperature_sampling)
    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.utils.figures import pyplot

    device = resolve_device(args.device)
    model, _ = load_model(
        args.model, overrides={"use_attention": args.use_attention,
                               "latent_injection": args.latent_injection},
        device=device)

    dataset = IDRIDDataset(args.data_dir, split="test", scale=args.scale,
                           patch_size=None, lesion_type=args.lesion_type,
                           max_images=args.max_images,
                           skip_border_check=args.skip_border_check)

    model_name = Path(args.model).stem
    mode = f"p{args.patch_size}" if args.patch_size else "full"
    out_dir = (Path(args.output_dir) / model_name / args.lesion_type / mode
               / f"T{args.temperature}" / f"N{args.samples}")
    out_dir.mkdir(parents=True, exist_ok=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M")
    written: List[Path] = []

    def save(fig, name: str) -> None:
        path = out_dir / name
        fig.savefig(path, dpi=150, bbox_inches="tight")
        pyplot().close(fig)
        written.append(path)

    count = 0
    for img_id in dataset.unique_image_ids():
        if args.max_images and count >= args.max_images:
            break
        logging.info("Visualizing %s", img_id)
        fig = plot_reconstruction(model, dataset, img_id, generator,
                                  num_samples=args.samples,
                                  patch_size=args.patch_size,
                                  temperature=args.temperature,
                                  batch_size=args.batch_size,
                                  overlap=args.overlap, device=device)
        save(fig, f"{img_id}_{timestamp}.png")

        if args.compare_temperatures or args.ensemble:
            img, mask = dataset.get_image_and_mask(img_id)
            if args.compare_temperatures:
                fig = visualize_temperature_sampling(
                    model, img, mask, generator,
                    temperatures=args.temperatures,
                    samples_per_temp=args.samples,
                    patch_size=args.patch_size, batch_size=args.batch_size,
                    overlap=args.overlap, device=device)
                save(fig, f"{img_id}_{timestamp}_temps.png")
            if args.ensemble:
                fig, results = generate_and_compare_ensemble(
                    model, img, mask, generator,
                    temperatures=args.temperatures,
                    samples_per_temp=args.samples, weighted=args.weighted,
                    patch_size=args.patch_size, batch_size=args.batch_size,
                    overlap=args.overlap, device=device)
                save(fig, f"{img_id}_{timestamp}_ensemble.png")
                logging.info("Ensemble results for %s: %s", img_id, results)
        count += 1
    logging.info("Wrote visualizations for %d images to %s", count, out_dir)
    return written


if __name__ == "__main__":
    main()
