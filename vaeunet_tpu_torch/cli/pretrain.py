#!/usr/bin/env python
"""Self-supervised pretraining of the ResNet encoder on the GPU.  Port of
``scripts/pretrain_encoder.py`` (the JAX package's script), with its 13
flags under the same ``dest`` and defaults, plus ``--device``:

    python -m vaeunet_tpu_torch.cli.pretrain --scale 1.0 --patch-size 512 \
        --epochs 40 --data-dir /path/to/data --out ./checkpoints/encoder_ssl

Trains the masked-reconstruction or the contrastive pretext
(``training/pretrain.py``) on the unlabeled train-split patches, gathered
on the device from a uint8 ``DeviceCache``, and writes the encoder's
state (``encoder.*``) to ``<out>/encoder.pt`` with ``torch.save``, which
``cli.train --pretrained-encoder <out>`` reads.  Runs on the CUDA device
(``--device cpu`` for the CPU).
"""

import argparse
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

log = logging.getLogger("pretrain")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Self-supervised encoder pretraining")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--patch-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--backbone", type=str, default="resnet34")
    p.add_argument("--lesion-type", type=str, default="EX",
                   help="Only selects which mask dir gates image ids; "
                   "pixels used are unlabeled images")
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--out", type=str, default="./checkpoints/encoder_ssl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-amp", dest="amp", action="store_false", default=True)
    p.add_argument("--pretext", choices=["masked", "contrastive"], default="masked",
                   help="masked = MAE-style inpainting; contrastive = SimCLR NT-Xent over "
                   "two augmented views")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """-> the path of the encoder file written."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import torch

    from vaeunet_tpu_torch.data.dataset import IDRIDDataset
    from vaeunet_tpu_torch.data.device_cache import DeviceCache
    from vaeunet_tpu_torch.data.loader import Loader
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.training.pretrain import (
        build_pretrain_model,
        create_pretrain_state,
        encoder_subtree,
        make_contrastive_step,
        make_pretrain_step,
    )

    device = resolve_device(args.device)
    ds = IDRIDDataset(args.data_dir, split="train", scale=args.scale,
                      patch_size=args.patch_size, lesion_type=args.lesion_type,
                      balance_seed=args.seed)
    cache = DeviceCache(ds, device)
    loader = Loader(ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                    index_only=True)
    log.info("Pretraining on %d patches", len(ds))

    model = build_pretrain_model(args.pretext, args.backbone, seed=args.seed, device=device)
    state = create_pretrain_state(model, args.learning_rate, seed=args.seed)
    if args.pretext == "contrastive":
        step = make_contrastive_step(model, amp=args.amp, indexed=True,
                                     temperature=args.temperature)
    else:
        step = make_pretrain_step(model, amp=args.amp, indexed=True)

    t0 = time.time()
    for epoch in range(1, args.epochs + 1):
        losses, mses = [], []
        for batch in loader:
            state, loss, mse = step(state, cache.images, cache.batch_indices(batch["idx"]))
            losses.append(loss)
            mses.append(mse)
        if losses:
            loss_m, mse_m = torch.stack([torch.stack(losses), torch.stack(mses)]).mean(1).tolist()
            log.info("epoch %d: loss %.5f masked-mse %.5f (%.1fs)", epoch, loss_m, mse_m,
                     time.time() - t0)

    out = Path(args.out).absolute()
    out.mkdir(parents=True, exist_ok=True)
    path = out / "encoder.pt"
    torch.save(encoder_subtree(state.model.state_dict()), path)
    log.info("Saved encoder checkpoint to %s", path)
    return path


if __name__ == "__main__":
    main()
