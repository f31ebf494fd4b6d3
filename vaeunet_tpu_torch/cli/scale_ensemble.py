#!/usr/bin/env python
"""Cross-scale ensemble evaluation on the GPU: fuse per-image mean
probability maps from several checkpoints (typically trained at different
scales).  Port of ``scripts/eval_scale_ensemble.py``, with every one of its
flags, dests, defaults and choices, plus ``--device`` (but ``--data-dir``'s
default, ``./data`` as in every other CLI, where the script names its own
host's data directory):

    python -m vaeunet_tpu_torch.cli.scale_ensemble \
        --member RUN_A@0.5 --member RUN_B@1.0 --lesion-type EX \
        --data-dir DIR --output-dir OUT

Each member is an N-sample tempered ensemble of its own
(``segmentation_distribution``, tiled at --patch-size) on the image at its
scale; its mean and its samples are resized to the ground truth, which is
at the largest member scale (bilinear, align_corners=False, through
``ops/resize.py``), clipped to [0, 1] and fused by max, mean or noisy-or
``1 - prod((1 - p_m)^w)``.  For exactly two members a linear mixing-weight
sweep (11 weights) is printed too.  With --output-dir the fused predictor's
reference-schema ``analysis_metrics.csv`` (7 columns; probability = the
fused map, uncertainty = the std of all members' samples pooled) goes to
``<output-dir>/<LESION>_T<T>_N<N>/``.

Differences from the script: one ``torch.Generator`` seeded by --seed
serves the members in the script's order (image, then member), which
cannot equal the JAX package's key splits (docs/PARITY.md #17); the host
metrics come from the port's ``uncertainty``.  Runs on the CUDA device
(``--device cpu`` for the CPU).
"""

import argparse
import logging
import time
from pathlib import Path
from typing import Optional, Sequence


def parse_member(spec: str):
    path, _, scale = spec.rpartition("@")
    if not path:
        raise argparse.ArgumentTypeError(
            f"--member must be CKPT_DIR@SCALE, got {spec!r}")
    return path, float(scale)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--member", action="append", type=parse_member,
                   required=True, metavar="CKPT_DIR@SCALE",
                   help="Repeatable; e.g. checkpoints/r2b/EX_...@0.5")
    p.add_argument("--lesion-type", default="EX")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--patch-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fusion", choices=["max", "mean", "noisyor"],
                   default="max",
                   help="noisyor: 1 - prod((1-p_m)^w) — a union of "
                        "independent detectors; boosts low-confidence "
                        "small-lesion hits that max-fusion leaves under "
                        "the decision threshold")
    p.add_argument("--fusion-weight", type=float, default=1.0,
                   help="Exponent w for noisyor fusion (>1 sharpens the union)")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="Decision threshold on the fused probability map")
    p.add_argument("--split", default="test", choices=["test", "val", "train"],
                   help="Dataset split to evaluate (use val to select "
                        "fusion hyperparameters without touching test)")
    p.add_argument("--output-dir", default=None,
                   help="If set, write the reference-schema analysis_metrics.csv "
                        "for the fused predictor under "
                        "<output-dir>/<LESION>_T<T>_N<N>/ (uncertainty = "
                        "pooled member samples resized to native resolution)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, report: Optional[dict] = None) -> dict:
    """-> {"fused_dice": {image: Dice of the fused map}, "pair": {image:
    the 11 mixing weights' Dice} (two members only), "weights", "rows": the
    CSV's rows, "csv": its path or None}.  `report`, a dict the caller
    passes, receives ``requests``: each member-image's member image size,
    the ground truth's and the seconds of its request and resizes."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import numpy as np
    import torch

    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.inference.predict import segmentation_distribution
    from vaeunet_tpu_torch.ops.resize import resize_bilinear
    from vaeunet_tpu_torch.uncertainty import (
        calculate_expected_calibration_error,
        calculate_sparsification_metrics,
        calculate_uncertainty_error_auc,
        calculate_uncertainty_error_dice,
        sparsification_error,
    )

    device = resolve_device(args.device)
    report = {} if report is None else report
    report["requests"] = []
    members = []        # (model, dataset, scale)
    gt_scale = max(s for _, s in args.member)
    for path, scale in args.member:
        model, _ = load_model(path, device=device)
        ds = IDRIDDataset(args.data_dir, split=args.split, scale=scale,
                          patch_size=None, lesion_type=args.lesion_type,
                          skip_border_check=True)
        members.append((model, ds, scale))
    gt_ds = next(ds for _, ds, s in members if s == gt_scale)

    generator = torch.Generator().manual_seed(args.seed)
    weights = np.linspace(0.0, 1.0, 11)
    pair_tbl = {}       # 2-member mixing sweep
    fused_tbl = {}
    csv_rows = []

    def to_gt(x, hw):
        """[N, h, w, 1] -> [N, *hw, 1], bilinear, align_corners=False."""
        return resize_bilinear(x.permute(0, 3, 1, 2), hw,
                               align_corners=False).permute(0, 2, 3, 1)

    for img_id in gt_ds.unique_image_ids():
        _, mask = gt_ds.get_image_and_mask(img_id)
        gt = np.asarray(mask)[..., 0]

        probs, sample_stacks = [], []
        for model, ds, scale in members:
            img, _ = ds.get_image_and_mask(img_id)
            t0 = time.perf_counter()
            with torch.inference_mode():
                samples, _, _ = segmentation_distribution(
                    model, img, generator, num_samples=args.samples,
                    temperature=args.temperature, patch_size=args.patch_size,
                    device=device)
                mean = samples.mean(dim=0, keepdim=True)
                if tuple(mean.shape[1:3]) != gt.shape[:2]:
                    mean = to_gt(mean, gt.shape[:2])
                    samples = to_gt(samples, gt.shape[:2])
                probs.append(mean[0, ..., 0].cpu().numpy())
                sample_stacks.append(samples[..., 0].cpu().numpy())
            report["requests"].append({"img_id": img_id, "hw": tuple(img.shape[:2]),
                                       "gt_hw": gt.shape[:2],
                                       "seconds": time.perf_counter() - t0})

        def dice_of(prob):
            pred = (prob > args.threshold).astype(np.float32)
            return float(2 * (pred * gt).sum() / (pred.sum() + gt.sum() + 1e-8))

        # 1-ulp bilinear overshoot can push probs past 1.0; clip before
        # fusion so (1-p)^w stays real (see uncertainty.py sparsification fix)
        stack = np.clip(np.stack(probs), 0.0, 1.0)
        if args.fusion == "max":
            fused = stack.max(axis=0)
        elif args.fusion == "mean":
            fused = stack.mean(axis=0)
        else:
            fused = 1.0 - np.prod((1.0 - stack) ** args.fusion_weight, axis=0)
        fused_tbl[img_id] = dice_of(fused)
        singles = "  ".join(f"m{i}={dice_of(p):.3f}"
                            for i, p in enumerate(probs))
        print(f"{img_id}: {singles}  {args.fusion}-fused={fused_tbl[img_id]:.3f}",
              flush=True)
        if len(members) == 2:
            pa, pb = probs
            pair_tbl[img_id] = [dice_of(w * pb + (1 - w) * pa)
                                for w in weights]

        if args.output_dir:
            # Fused predictor metrics in the reference analyze_model.py
            # 7-column schema.  Probability map = the fused map; per-pixel
            # uncertainty = std over ALL member samples at native res.
            pooled = np.concatenate(sample_stacks)
            std_dev = pooled.std(axis=0)
            pred_binary = (fused > args.threshold).astype(np.float32)
            ece, *_ = calculate_expected_calibration_error(fused, gt)
            ue_dice = calculate_uncertainty_error_dice(std_dev, pred_binary, gt)
            se = sparsification_error(*calculate_sparsification_metrics(
                fused[None], std_dev[None], gt[None], num_points=20))
            auroc, auprc = calculate_uncertainty_error_auc(fused, gt, std_dev)
            csv_rows.append({
                "img_id": str(img_id), "dice": fused_tbl[img_id], "ece": ece,
                "sparsification_error": se, "uncertainty_error_dice": ue_dice,
                "error_auroc": auroc, "error_auprc": auprc,
            })

    if pair_tbl:
        print("\nw_b  " + "  ".join(f"{w:.1f}" for w in weights))
        for img_id, row in pair_tbl.items():
            print(f"{img_id}: " + "  ".join(f"{d:.3f}" for d in row))
        means = np.mean(np.array(list(pair_tbl.values())), axis=0)
        print("mean: " + "  ".join(f"{d:.3f}" for d in means))
        print(f"best mixed mean dice: {means.max():.4f} "
              f"at w_b={weights[means.argmax()]:.1f}")
    print(f"{args.fusion}-fusion mean dice: "
          f"{np.mean(list(fused_tbl.values())):.4f}")

    csv = None
    if args.output_dir:
        import pandas as pd
        out = (Path(args.output_dir)
               / f"{args.lesion_type}_T{args.temperature}_N{args.samples}")
        out.mkdir(parents=True, exist_ok=True)
        df = pd.DataFrame(csv_rows)
        csv = out / "analysis_metrics.csv"
        df.to_csv(csv, index=False)
        print(f"wrote {csv} (fusion={args.fusion}, mean dice {df['dice'].mean():.4f})")
    return {"fused_dice": fused_tbl, "pair": pair_tbl, "weights": weights,
            "rows": csv_rows, "csv": csv}


if __name__ == "__main__":
    main()
