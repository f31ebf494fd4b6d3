"""The EfficientNet-B4 VAE-UNet: its plain reference, and the program built
from ``vaeunet_effb4.json`` as ``training/loop.py`` and ``cli.analyze``
build it.  Deep supervision stays off: the training driver's reference loss
(``reference/train.py::loss_of``) has no auxiliary heads."""

from __future__ import annotations

from benchmark.reference.efficientnet import EfficientNetVAEUNet

HAS_LATENT = True


def reference_model(cfg):
    return EfficientNetVAEUNet(cfg["n_channels"], cfg["n_classes"], cfg["latent_dim"],
                               cfg["logvar_clamp"])


def program_train(cfg, traffic, device):
    """-> (state, step): the loop's indexed train step at the cell's batch."""
    from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    t = cfg["train"]
    config = TrainConfig(
        model_type="resnet", n_channels=cfg["n_channels"], n_classes=cfg["n_classes"],
        backbone=cfg["backbone"], latent_dim=cfg["latent_dim"],
        latent_injection=cfg["latent_injection"], use_attention=cfg["use_attention"],
        use_skip=cfg["use_skip"], deep_supervision=cfg["deep_supervision"],
        batch_size=traffic["batch"], gradient_accumulation_steps=1,
        patch_size=traffic["hw"], amp=t["amp"], learning_rate=t["learning_rate"],
        weight_decay=t["weight_decay"], gradient_clipping=t["gradient_clipping"],
        beta=t["beta"], free_bits=t["free_bits"])
    state = create_train_state(config, seed=0, device=device)
    return state, make_train_step(config, state.model, indexed=True)


def program_serving(cfg, device):
    """The serving model, in eval mode, fp32 with TF32 off."""
    from vaeunet_tpu_torch.models.vae_unet import build_model

    return build_model(cfg["n_channels"], cfg["n_classes"], backbone=cfg["backbone"],
                       latent_dim=cfg["latent_dim"], latent_injection=cfg["latent_injection"],
                       use_attention=cfg["use_attention"], use_skip=cfg["use_skip"],
                       logvar_clamp=cfg["logvar_clamp"], seed=0, device=device)
