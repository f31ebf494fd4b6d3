#!/usr/bin/env python
"""Train the (VAE-)UNet on fundus images on the GPU.  Port of the top-level
``train.py`` (the JAX package's CLI), with every one of its flags under the
same ``dest``:

    python -m vaeunet_tpu_torch.cli.train --data-dir DIR --scale 0.5 \
        --patch-size 512 --batch-size 16 --gradient-accumulation-steps 1

Runs ``training.loop.train_model`` on the CUDA device (``--device cpu`` for
the CPU).  ``--resume RUN_DIR`` restores the full training state from
``RUN_DIR/best``; ``--load`` takes only the model's weights, from a run dir
of this package or a reference ``.pth`` (``compat/loading.py``; a JAX
orbax run dir is refused there).  ``--pretrained-encoder DIR`` starts the
encoder from ``DIR/encoder.pt``, written by ``cli.pretrain``
(``train.py:187-199``).  ``--num-devices N`` above 1 trains data-parallel
on N ranks (``parallel.dp.run_train_dp``, ``train.py:201-203``): N cards,
or with ``--device cpu`` N gloo ranks on the CPU; fewer cards than N
raise.
"""

import argparse
import logging
from typing import Optional, Sequence


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train the UNet on images and target masks")
    parser.add_argument("--epochs", "-e", metavar="E", type=int, default=100)
    parser.add_argument("--batch-size", "-b", dest="batch_size", metavar="B",
                        type=int, default=6)
    parser.add_argument("--learning-rate", "-l", metavar="LR", type=float,
                        default=1e-4)
    parser.add_argument("--load", "-f", type=str, default=False,
                        help="Load model weights from a run dir of this package "
                        "or a reference .pth (a JAX orbax run dir needs jax: "
                        "refused)")
    parser.add_argument("--reset-best", action="store_true", default=False,
                        help="With --resume: start best-val tracking fresh "
                        "(fine-tunes under a new objective save their own best)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Resume full training state from a run dir")
    parser.add_argument("--scale", "-s", type=float, default=1.0)
    parser.add_argument("--validation", "-v", dest="val", type=float,
                        default=10.0, help="(kept for flag parity; unused — "
                        "IDRiD ships explicit splits)")
    parser.add_argument("--amp", action="store_true", default=True)
    parser.add_argument("--no-amp", dest="amp", action="store_false")
    parser.add_argument("--bilinear", action="store_true", default=False)
    parser.add_argument("--classes", "-c", type=int, default=1)
    parser.add_argument("--patch-size", "-p",
                        type=lambda x: None if x.lower() == "none" else int(x),
                        default=None)
    parser.add_argument("--gradient-clipping", type=float, default=1.0)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--use-checkpointing", action="store_true", default=False,
                        help="Gradient rematerialization (memory saver)")
    parser.add_argument("--remat-policy", type=str, default="full",
                        choices=["full", "save_convs"],
                        help="With --use-checkpointing: 'save_convs' keeps "
                        "conv/resize products and recomputes only BN/ReLU")
    parser.add_argument("--gradient-accumulation-steps", type=int, default=2)
    parser.add_argument("--early-stopping-patience", type=int, default=5)
    parser.add_argument("--loss", type=str, default="auto",
                        choices=["auto", "combined", "focal"],
                        help="Override the per-lesion loss rule (auto = "
                        "reference behavior: MA->focal+dice, else BCE+dice)")
    parser.add_argument("--lesion-type", type=str, default="EX")
    parser.add_argument("--model-type", type=str, default="resnet",
                        choices=["basic", "resnet"])
    parser.add_argument("--skip", dest="use_skip", action="store_true")
    parser.add_argument("--no-skip", dest="use_skip", action="store_false")
    parser.add_argument("--attention", dest="use_attention", action="store_true")
    parser.add_argument("--no-attention", dest="use_attention",
                        action="store_false")
    parser.add_argument("--kl-anneal-epochs", type=int, default=20)
    parser.add_argument("--free-bits", type=float, default=1e-3)
    parser.add_argument("--latent-injection", type=str, default="all",
                        choices=["all", "first", "last", "bottleneck",
                                 "inject_no_bottleneck", "none"])
    parser.add_argument("--beta", type=float, default=0.001)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--dataset", type=str, default="idrid",
                        choices=["idrid", "basic"],
                        help="'basic' = Carvana-style dir-of-images dataset")
    parser.add_argument("--mask-suffix", type=str, default="_mask")
    parser.add_argument("--checkpoint-dir", type=str, default="./checkpoints")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="Data-parallel devices: N > 1 trains on N ranks, one a card "
                        "(--device cpu: N processes on the CPU)")
    parser.add_argument("--lr-patience", type=int, default=None,
                        help="Plateau-LR patience override (validations)")
    parser.add_argument("--lr-factor", type=float, default=None,
                        help="Plateau-LR decay factor override")
    parser.add_argument("--device-cache-max-bytes", type=int,
                        default=6_000_000_000,
                        help="Device-memory budget for the device-resident dataset")
    parser.add_argument("--no-device-cache", dest="device_cache",
                        action="store_false", default=True,
                        help="Disable the device-resident dataset (host-fed "
                        "batches through pinned memory)")
    parser.add_argument("--pretrained-encoder", type=str, default=None,
                        metavar="DIR",
                        help="Init the ResNet encoder from a self-supervised "
                        "checkpoint: DIR/encoder.pt of cli.pretrain")
    parser.add_argument("--oversample-large-lesions", type=float, default=0.0,
                        dest="oversample_lesion", metavar="K",
                        help="Replicate large-lesion train patches "
                        "(1 + min(4, floor(lesion_frac * K)) copies); 0 keeps "
                        "the reference's balanced sampling")
    parser.add_argument("--deep-supervision", action="store_true",
                        default=False,
                        help="Aux dice+BCE losses on decoder levels 0-2 "
                        "(framework extension; from-scratch training aid)")
    parser.add_argument("--kl-clamp-leak", type=float, default=0.0,
                        help="Gradient leak through the +-100 KL clamp "
                        "(0 = reference parity; ~0.01 restores a restoring "
                        "force on runaway latent dims)")
    parser.add_argument("--debug-nans", action="store_true", default=False,
                        help="Anomaly detection in the forward and backward, "
                        "and a non-finite loss raises (the reference's NaN "
                        "guards as a debug mode)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.set_defaults(use_attention=True, use_skip=True)
    return parser


def config_from_args(args):
    from vaeunet_tpu_torch.training.config import TrainConfig

    return TrainConfig(
        model_type=args.model_type,
        n_channels=3,
        n_classes=args.classes,
        bilinear=args.bilinear,
        use_attention=args.use_attention,
        use_skip=args.use_skip,
        latent_injection=args.latent_injection,
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        amp=args.amp,
        gradient_clipping=args.gradient_clipping,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        early_stopping_patience=args.early_stopping_patience,
        beta=args.beta,
        free_bits=args.free_bits,
        kl_anneal_epochs=args.kl_anneal_epochs,
        data_dir=args.data_dir,
        dataset_type=args.dataset,
        mask_suffix=args.mask_suffix,
        img_scale=args.scale,
        patch_size=args.patch_size,
        max_images=args.max_images,
        lesion_type=args.lesion_type,
        loss=args.loss,
        reset_best=args.reset_best,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        use_remat=args.use_checkpointing,
        remat_policy=args.remat_policy,
        num_devices=args.num_devices,
        device_cache=args.device_cache,
        device_cache_max_bytes=args.device_cache_max_bytes,
        debug_nans=args.debug_nans,
        lr_patience=args.lr_patience,
        lr_factor=args.lr_factor,
        oversample_lesion=args.oversample_lesion,
        deep_supervision=args.deep_supervision,
        kl_clamp_leak=args.kl_clamp_leak,
    )


def main(argv: Optional[Sequence[str]] = None):
    """-> the final ``TrainState``; with ``--num-devices`` above 1, rank 0's
    final ``{"step", "model"}`` (``parallel.dp.run_train_dp``)."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    from vaeunet_tpu_torch.compat.loading import load_encoder_state, load_state
    from vaeunet_tpu_torch.device import resolve_device
    from vaeunet_tpu_torch.training.loop import train_model
    from vaeunet_tpu_torch.training.pretrain import transplant_encoder
    from vaeunet_tpu_torch.training.state import build_model

    device = resolve_device(args.device)
    logging.info("Using device: %s", device)
    config = config_from_args(args)
    model_state = None
    if args.load:
        model_state, _ = load_state(args.load)
        logging.info("Loaded weights from %s", args.load)
    if args.pretrained_encoder:
        if model_state is None:     # the init train_model would make
            model_state = build_model(config, seed=config.seed, device=device).state_dict()
        model_state = transplant_encoder(model_state, load_encoder_state(args.pretrained_encoder))
        logging.info("Initialized encoder from %s", args.pretrained_encoder)
    if config.num_devices > 1:
        from vaeunet_tpu_torch.parallel.dp import run_train_dp
        return run_train_dp(config, device=device.type, model_state=model_state,
                            resume_from=args.resume)
    return train_model(config, model_state=model_state, resume_from=args.resume, device=device)


if __name__ == "__main__":
    main()
