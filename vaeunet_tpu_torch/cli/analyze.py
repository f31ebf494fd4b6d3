#!/usr/bin/env python
"""Analyze VAE-UNet performance and uncertainty on the GPU.  Port of the
top-level ``analyze_model.py`` (the JAX package's CLI; reference
``analyze_model.py:1230-1269``), with every one of its flags under the same
``dest``, plus ``--device``:

    python -m vaeunet_tpu_torch.cli.analyze --model RUN_DIR_OR.pth \
        --lesion_type EX --patch_size 512 --data-dir DIR

Loads a checkpoint (a reference ``.pth`` or a run dir of this package),
runs the N-sample uncertainty analysis over the test split on the CUDA
device (``--device cpu`` for the CPU), and writes ``analysis_metrics.csv``
and the global plots under ``<output_dir>/<LESION>_T<T>_N<N>/``.
"""

import argparse
import logging
from typing import Optional, Sequence


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Analyze VAE-UNet model performance and uncertainty")
    parser.add_argument("--model", "-m", default="best_model.pth", metavar="FILE")
    parser.add_argument("--lesion_type", type=str, required=True,
                        choices=["EX", "HE", "MA", "SE", "OD"])
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--samples", type=int, default=10)
    parser.add_argument("--patch_size", type=int, default=None)
    parser.add_argument("--overlap", type=int, default=100)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--attention", dest="use_attention", action="store_true")
    parser.add_argument("--no-attention", dest="use_attention",
                        action="store_false")
    parser.add_argument("--latent-injection", type=str, default="all",
                        choices=["all", "first", "last", "bottleneck",
                                 "inject_no_bottleneck", "none"])
    parser.add_argument("--output_dir", type=str, default="./analysis_results")
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--temp_values", type=float, nargs="+",
                        default=[0.5, 1.0, 1.5, 2.0, 2.5, 3.0])
    parser.add_argument("--model_label", type=str, default="VAE-UNet")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--extended-metrics", action="store_true",
                        help="Emit the older analyzer's superset columns")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str, default="VAE_UNet_Analysis")
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threshold-mode", choices=["fixed", "area"],
                        default="fixed",
                        help="Decision rule: global 0.5 (reference "
                             "behavior) or per-image expected-area "
                             "threshold (framework extension)")
    parser.add_argument("--area-factor", type=float, default=1.0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.set_defaults(use_attention=True)
    return parser


def main(argv: Optional[Sequence[str]] = None, report: Optional[dict] = None):
    """-> the per-image metrics DataFrame.  `report`: see
    ``analysis.analyze.analyze_model``."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    from vaeunet_tpu_torch.analysis.analyze import AnalyzeArgs, analyze_model
    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.utils.tracking import Tracker

    device = resolve_device(args.device)
    tracker = None
    if not args.no_wandb:
        tracker = Tracker(project=args.wandb_project, config=vars(args),
                          job_type="analysis")

    model, _ = load_model(
        args.model, overrides={"use_attention": args.use_attention,
                               "latent_injection": args.latent_injection},
        device=device)

    dataset = IDRIDDataset(args.data_dir, split="test", scale=args.scale,
                           patch_size=None, lesion_type=args.lesion_type,
                           max_images=args.max_images, skip_border_check=True)

    a = AnalyzeArgs(
        lesion_type=args.lesion_type, temperature=args.temperature,
        samples=args.samples, patch_size=args.patch_size,
        overlap=args.overlap, output_dir=args.output_dir,
        max_images=args.max_images, temp_values=tuple(args.temp_values),
        model_label=args.model_label, batch_size=args.batch_size,
        extended_metrics=args.extended_metrics, seed=args.seed,
        threshold_mode=args.threshold_mode, area_factor=args.area_factor)
    df = analyze_model(model, dataset, a, tracker=tracker, device=device, report=report)
    if tracker:
        tracker.finish()
    logging.info("Analyzed %d images", len(df))
    return df


if __name__ == "__main__":
    main()
