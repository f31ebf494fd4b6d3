"""Single dataclass config shared by all entry points.  A copy of
``vaeunet_tpu/training/config.py`` (the port may not import that package):
the same fields, defaults, JSON round trip and ``checkpoint_path``.

Defaults mirror the reference train.py:626-665.  ``amp=True`` means bf16
activations with fp32 parameters, BN statistics and loss (no loss scaling);
fields that only the JAX package's loop, data cache or mesh reads are kept
so configs round-trip between the two packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass
class TrainConfig:
    # model (train.py:645-662, unet_resnet.py:104)
    model_type: str = "resnet"              # 'basic' | 'resnet'
    n_channels: int = 3
    n_classes: int = 1
    bilinear: bool = False
    backbone: str = "resnet34"
    pretrained: bool = True
    latent_dim: int = 32
    use_attention: bool = True
    use_skip: bool = True
    latent_injection: Union[str, Tuple[int, ...]] = "all"

    # optimization (train.py:626-643)
    epochs: int = 100
    batch_size: int = 6
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5              # train.py:323,334
    amp: bool = True                        # bf16 activations (no loss scaling)
    gradient_clipping: float = 1.0
    gradient_accumulation_steps: int = 2
    early_stopping_patience: int = 5

    # VAE (train.py:655-664)
    beta: float = 0.001
    free_bits: float = 1e-3
    kl_anneal_epochs: int = 20

    # plateau-LR overrides (None = the reference's per-lesion defaults,
    # train.py:322-342; from-scratch encoders want a gentler schedule than
    # the reference's pretrained-encoder tuning)
    lr_patience: Optional[int] = None
    lr_factor: Optional[float] = None

    # data (train.py:630-640, data_loading.py:45-47)
    data_dir: str = "./data"
    dataset_type: str = "idrid"             # 'idrid' | 'basic' (Carvana-style)
    mask_suffix: str = "_mask"              # for 'basic' datasets
    img_scale: float = 1.0
    patch_size: Optional[int] = None
    max_images: Optional[int] = None
    lesion_type: str = "EX"
    # 'auto' = reference rule (MA->focal+dice, else BCE+dice);
    # 'combined'/'focal' force that loss for any lesion type
    loss: str = "auto"
    # With --resume: do not carry the restored best-val score, so a
    # fine-tune under a different objective saves its own best checkpoint
    reset_best: bool = False
    skip_border_check: bool = False
    # >0 replicates large-lesion train patches (1 + min(4, floor(frac * k))
    # copies); compensates for the missing ImageNet-pretrained encoder on
    # confluent plaques. 0 = reference-parity balanced sampling.
    oversample_lesion: float = 0.0
    # Deep supervision: aux dice+BCE losses on decoder levels 0-2 (weights
    # 1/2^k of the main loss, normalized). Framework extension for
    # from-scratch training; 0ff = reference parity.
    deep_supervision: bool = False
    # Gradient leak through the reference's hard KL clamp (losses.py
    # kl_with_free_bits). 0 = reference parity (clamp zeroes the gradient
    # of runaway latent dims — observed logvar random-walk to var ~3e10 at
    # scale 1.0); >0 restores a small pull toward the +-100 rails without
    # changing the loss VALUE.
    kl_clamp_leak: float = 0.0

    # infra
    seed: int = 42
    checkpoint_dir: str = "./checkpoints"
    save_checkpoint: bool = True
    # also keep a timestamped copy per improvement (reference train.py:535-541
    # keeps model_<ts>_ep<e>_dice<d>.pth alongside best_model.pth); off by
    # default because each save costs ~20s on remote storage
    save_all_improvements: bool = False
    num_workers: int = 6                    # host-side prefetch threads
    use_remat: bool = False
    # 'full' | 'save_convs' (save conv/resize products, recompute BN/ReLU)
    remat_policy: str = "full"
    # Keep the whole patch set resident in HBM as uint8 and gather batches
    # on-device (data.device_cache). Auto-disabled when the set exceeds
    # device_cache_max_bytes, in full-image mode, or under multi-device DP.
    device_cache: bool = True
    device_cache_max_bytes: int = 6_000_000_000
    # Debug surface (SURVEY.md section 5 sanitizer row): jax_debug_nans +
    # donation disabled so intermediate buffers survive for inspection.
    debug_nans: bool = False

    # parallelism (TPU-native addition; 1 = single chip)
    num_devices: int = 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if isinstance(d.get("latent_injection"), tuple):
            d["latent_injection"] = list(d["latent_injection"])
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        if isinstance(d.get("latent_injection"), list):
            d["latent_injection"] = tuple(d["latent_injection"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def checkpoint_path(self) -> str:
        """Structured checkpoint dir name encoding hyperparameters, matching
        reference train.py:62-108 (get_checkpoint_path)."""
        patch_str = f"patch{self.patch_size}" if self.patch_size is not None else "full_img"
        if self.img_scale == int(self.img_scale):
            scale_str = f"scale{int(self.img_scale)}"
        else:
            scale_str = f"scale{self.img_scale:.1f}"
        attention_str = "attn" if self.use_attention else "no_attn"
        kl_str = f"beta{self.beta:.4f}" if self.beta > 0 else "noKL"
        if self.free_bits > 0:
            kl_str += f"_fb{self.free_bits:.4f}"
        if self.kl_anneal_epochs > 0:
            kl_str += f"_anneal{self.kl_anneal_epochs}"
        li = self.latent_injection
        latent_str = f"_latent{li}" if li and li != "none" else ""
        lr_str = f"_lr{self.learning_rate}"
        seed_str = f"_seed{self.seed}" if self.seed is not None else ""
        name = (f"{self.lesion_type}_{self.model_type}_{attention_str}_"
                f"{scale_str}_{patch_str}_{kl_str}{latent_str}{lr_str}{seed_str}")
        return f"{self.checkpoint_dir}/{name}"
