#!/usr/bin/env python
"""Predict masks from input images on the GPU.  Port of the top-level
``predict.py`` (the milesial-style CLI), with every one of its flags, plus
``--device``:

    python -m vaeunet_tpu_torch.cli.predict --model RUN_DIR_OR.pth \
        --input fundus.png --scale 0.5

For each image: ``data.dataset.preprocess_pil`` at ``--scale``,
``inference.predict_image`` (the plain UNet's forward, or the VAE-UNet's
deterministic z = mu forward), the probabilities resized back to the input's
size (align_corners=False), ``> --mask-threshold``, a PNG.  The checkpoint
decides the architecture; --model-type, --classes and --bilinear are kept
for flag parity.  Runs on the CUDA device (``--device cpu`` for the CPU).
"""

import argparse
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Predict masks from input images")
    parser.add_argument("--model", "-m", default="MODEL.pth", metavar="FILE",
                        help="Specify the file in which the model is stored")
    parser.add_argument("--input", "-i", metavar="INPUT", nargs="+",
                        help="Filenames of input images", required=True)
    parser.add_argument("--output", "-o", metavar="OUTPUT", nargs="+",
                        help="Filenames of output images")
    parser.add_argument("--viz", "-v", action="store_true",
                        help="Visualize the images as they are processed")
    parser.add_argument("--no-save", "-n", action="store_true",
                        help="Do not save the output masks")
    parser.add_argument("--mask-threshold", "-t", type=float, default=0.5,
                        help="Minimum probability to consider a mask pixel white")
    parser.add_argument("--scale", "-s", type=float, default=0.5,
                        help="Scale factor for the input images")
    parser.add_argument("--bilinear", action="store_true", default=False)
    parser.add_argument("--classes", "-c", type=int, default=1)
    parser.add_argument("--model-type", type=str, default="basic",
                        choices=["basic", "resnet"])
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser


def _out_name(in_path: str) -> str:
    p = Path(in_path)
    return str(p.with_name(f"{p.stem}_OUT.png"))


def predict_img(model, pil_img, scale: float, threshold: float, device=None) -> np.ndarray:
    """[H, W] bool mask of one PIL image at its own size (predict.py:45-61)."""
    from vaeunet_tpu_torch.data.dataset import preprocess_pil
    from vaeunet_tpu_torch.inference.predict import predict_image
    from vaeunet_tpu_torch.ops.resize import resize_bilinear

    arr = preprocess_pil(pil_img, scale, is_mask=False).astype(np.float32) / 255.0
    probs, _ = predict_image(model, arr, out_threshold=threshold, device=device)
    # upscale probabilities back to the original size then threshold
    # (milesial predict semantics)
    full = resize_bilinear(probs.permute(2, 0, 1)[None], (pil_img.size[1], pil_img.size[0]),
                           align_corners=False)[0, 0]
    return (full > threshold).cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """-> the mask files written."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    from vaeunet_tpu_torch.compat.loading import load_model
    from vaeunet_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # architecture comes from the checkpoint itself (state-dict keys for
    # .pth, stored config for run dirs); --model-type/--classes/--bilinear
    # are accepted for milesial flag parity but the checkpoint wins.
    model, _ = load_model(args.model, device=device)
    logging.info("Model loaded from %s", args.model)

    out_files = args.output or [_out_name(f) for f in args.input]
    written = []
    for in_file, out_file in zip(args.input, out_files):
        logging.info("Predicting image %s ...", in_file)
        img = Image.open(in_file).convert("RGB")
        mask = predict_img(model, img, args.scale, args.mask_threshold, device=device)
        if not args.no_save:
            Image.fromarray((mask * 255).astype(np.uint8)).save(out_file)
            written.append(out_file)
            logging.info("Mask saved to %s", out_file)
        if args.viz:
            from vaeunet_tpu_torch.utils.figures import pyplot
            plt = pyplot()
            fig, axes = plt.subplots(1, 2, figsize=(10, 5))
            axes[0].imshow(img)
            axes[0].set_title("Input image")
            axes[1].imshow(mask, cmap="gray")
            axes[1].set_title("Output mask")
            for a in axes:
                a.axis("off")
            viz_path = str(Path(out_file).with_suffix(".viz.png"))
            fig.savefig(viz_path, dpi=150, bbox_inches="tight")
            plt.close(fig)
            logging.info("Visualization saved to %s", viz_path)
    return written


if __name__ == "__main__":
    main()
