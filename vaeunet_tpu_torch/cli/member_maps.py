#!/usr/bin/env python
"""Compute cached per-member probability maps for ensemble fusion and
tuning on the GPU.  Port of ``scripts/compute_member_maps.py``, with every
one of its flags, dests, defaults and choices, plus ``--device`` (but
``--data-dir``'s default, ``./data`` as in every other CLI, where the
script names its own host's data directory):

    python -m vaeunet_tpu_torch.cli.member_maps --lesion-type EX \
        --member b05=RUN_DIR@0.5 --member f10F=best.pth@1.0:h \
        --split val --outdir MAPS/val --data-dir DIR

For each (member, image) it saves under --outdir:
  <label>_<img>.npy       float32 [H, W]   mean probability over N samples
  <label>_<img>_mom.npy   float32 [2,H,W]  sample sum and sum of squares
  gt_<img>.npy            uint8  [H, W]    ground truth at scale 1.0

These are the inputs of ``cli.tune_fusion``.  A member is
``label=checkpoint@scale[:h|:v][:cK]``: a checkpoint ``compat.load_model``
reads (a port run dir, a reference ``.pth``, or a JAX run dir exported by
``scripts/export_jax_checkpoint.py``), the scale its image is read at, a
flip for test-time augmentation, and for a multi-task (``lesion_type='ALL'``)
checkpoint the output channel to read.  Each member-image is one
``segmentation_distribution`` request (tiled at --patch-size, N = --samples
at --temperature); its samples not at the ground truth's size are resized
bilinearly (align_corners=False, the data pipeline's convention) by
``ops/resize.py``.  The map file is written last, through a rename, and is
the resume key: existing maps are skipped, so interrupted runs resume.

Difference from the script: the latent noise comes from one
``torch.Generator`` seeded by --seed, drawn in the script's order (image,
then member); it cannot equal the JAX package's key splits
(docs/PARITY.md #17).  Runs on the CUDA device (``--device cpu`` for the
CPU).
"""
import argparse
import gc
import logging
import time
from pathlib import Path
from typing import Optional, Sequence


def parse_member(spec: str):
    """label=checkpoint@scale[:h|:v][:cK] — flip TTA and, for multi-task
    (lesion_type='ALL') checkpoints, the output channel to read."""
    label, rest = spec.split("=", 1)
    parts = rest.split(":")
    rest, flip, channel = parts[0], None, 0
    for tok in parts[1:]:
        if tok in ("h", "v"):
            flip = tok
        elif tok.startswith("c") and tok[1:].isdigit():
            channel = int(tok[1:])
        else:
            raise ValueError(f"unknown member flag {tok!r} in {spec!r}")
    ckpt, scale = rest.rsplit("@", 1)
    return label, ckpt, float(scale), flip, channel


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--member", action="append", required=True,
                   help="label=checkpoint@scale[:h|:v]")
    p.add_argument("--lesion-type", required=True)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--outdir", required=True)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--patch-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--images", action="append", default=None,
                   help="Restrict to these image ids (repeatable); default "
                        "all images in the split")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None, report: Optional[dict] = None) -> dict:
    """-> {"written": the maps written, "skipped": the (label, image) pairs
    whose map existed}.  `report`, a dict the caller passes, receives
    ``maps``: for each map written its label, image, the member's image
    size, the ground truth's size and the seconds from the request to the
    saved map."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import numpy as np
    import torch

    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.inference.predict import segmentation_distribution
    from vaeunet_tpu_torch.ops.resize import resize_bilinear

    device = resolve_device(args.device)
    report = {} if report is None else report
    report["maps"] = []
    members = [parse_member(s) for s in args.member]
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    for stale in out.glob(".tmp.*.npy"):  # killed mid-rename
        stale.unlink()

    ds_by_scale = {}
    for _, _, scale, _, _ in members:
        ds_by_scale.setdefault(scale, IDRIDDataset(
            args.data_dir, split=args.split, scale=scale, patch_size=None,
            lesion_type=args.lesion_type, skip_border_check=True))
    ds_by_scale.setdefault(1.0, IDRIDDataset(
        args.data_dir, split=args.split, scale=1.0, patch_size=None,
        lesion_type=args.lesion_type, skip_border_check=True))
    gt_ds = ds_by_scale[1.0]

    model_cache = {}

    def load(ckpt):
        if ckpt not in model_cache:
            model_cache[ckpt] = load_model(ckpt, device=device)[0]
        return model_cache[ckpt]

    generator = torch.Generator().manual_seed(args.seed)
    img_ids = gt_ds.unique_image_ids()
    if args.images:
        img_ids = [i for i in img_ids if i in set(args.images)]
    written, skipped = [], []
    for img_id in img_ids:
        gt_path = out / f"gt_{img_id}.npy"
        if not gt_path.exists():
            _, mask = gt_ds.get_image_and_mask(img_id)
            np.save(gt_path, np.asarray(mask)[..., 0].astype(np.uint8))
        gt_shape = tuple(np.load(gt_path, mmap_mode="r").shape[:2])
        for label, ckpt, scale, flip, channel in members:
            if (out / f"{label}_{img_id}.npy").exists():
                skipped.append((label, img_id))
                continue
            model = load(ckpt)
            img, _ = ds_by_scale[scale].get_image_and_mask(img_id)
            t0 = time.perf_counter()
            with torch.inference_mode():
                img = torch.as_tensor(img, dtype=torch.float32, device=device)
                if flip == "h":
                    img = torch.flip(img, dims=[1])
                elif flip == "v":
                    img = torch.flip(img, dims=[0])
                samples, _, _ = segmentation_distribution(
                    model, img, generator, num_samples=args.samples,
                    temperature=args.temperature, patch_size=args.patch_size, device=device)
                if flip == "h":
                    samples = torch.flip(samples, dims=[2])
                elif flip == "v":
                    samples = torch.flip(samples, dims=[1])
                if tuple(samples.shape[1:3]) != gt_shape:
                    samples = resize_bilinear(samples.permute(0, 3, 1, 2), gt_shape,
                                              align_corners=False).permute(0, 2, 3, 1)
                s = samples[..., channel].cpu().numpy()
            # mom first, map last via rename: the map file is the skip key,
            # so its presence must imply both files are complete (a kill
            # mid-np.save must not leave a truncated map that resumes trust)
            np.save(out / f"{label}_{img_id}_mom.npy",
                    np.stack([s.sum(0), (s ** 2).sum(0)]).astype(np.float32))
            tmp = out / f".tmp.{label}.{img_id}.npy"
            np.save(tmp, s.mean(0).astype(np.float32))
            tmp.replace(out / f"{label}_{img_id}.npy")
            report["maps"].append({"label": label, "img_id": img_id,
                                   "hw": tuple(img.shape[:2]), "gt_hw": gt_shape,
                                   "seconds": time.perf_counter() - t0})
            written.append(out / f"{label}_{img_id}.npy")
            del samples, s
            print(f"map {out} {label} {img_id} done", flush=True)
        gc.collect()
    return {"written": written, "skipped": skipped}


if __name__ == "__main__":
    main()
