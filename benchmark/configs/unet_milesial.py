"""The attention UNet (milesial channel plan): its plain reference, and the
program's train step built from ``unet_milesial.json``."""

from __future__ import annotations

from benchmark.reference.unet import UNet

HAS_LATENT = False


def reference_model(cfg):
    return UNet(cfg["n_channels"], cfg["n_classes"])


def program_train(cfg, traffic, device):
    """-> (state, step): the loop's indexed train step at the cell's batch."""
    from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    t = cfg["train"]
    config = TrainConfig(
        model_type="basic", n_channels=cfg["n_channels"], n_classes=cfg["n_classes"],
        bilinear=cfg["bilinear"], batch_size=traffic["batch"], gradient_accumulation_steps=1,
        patch_size=traffic["hw"], amp=t["amp"], learning_rate=t["learning_rate"],
        weight_decay=t["weight_decay"], gradient_clipping=t["gradient_clipping"],
        beta=t["beta"], free_bits=t["free_bits"])
    state = create_train_state(config, seed=0, device=device)
    return state, make_train_step(config, state.model, indexed=True)
