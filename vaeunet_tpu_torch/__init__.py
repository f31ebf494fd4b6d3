"""vaeunet_tpu_torch — the PyTorch/CUDA port of ``vaeunet_tpu``.

A second package beside the JAX one, which stays the reference it is
tested against.  It imports torch and numpy only: never jax, and nothing of
``vaeunet_tpu``.  The modules mirror the JAX package file for file; every
Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, built and bound by ``ops/_ext.py``) with a plain PyTorch
version beside its wrapper.

Ported so far: the N-sample uncertainty serving path of the ResNet
VAE-UNet (``inference.segmentation_distribution``, ``uncertainty_maps``,
``predict_image``, ``predict_tiled_ensemble``) and its train and eval steps
(``training.create_train_state``, ``make_train_step``, ``make_eval_step``,
with ``losses`` and ``metrics``); the plain UNet (``models.UNet``,
``build_unet``) through the same serving call and steps; the
resnet18/34/50/101 backbones, deep supervision and remat.  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from vaeunet_tpu_torch.device import resolve_device, use_fp32_numerics
from vaeunet_tpu_torch.models import UNet, UNetResNet, build_model, build_unet, capture_attention
from vaeunet_tpu_torch.inference import (
    predict_full_image,
    predict_image,
    predict_tiled_ensemble,
    segmentation_distribution,
    uncertainty_maps,
)
from vaeunet_tpu_torch.compat import convert_jax_unet, convert_jax_unet_resnet, load_jax_variables
from vaeunet_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "resolve_device",
    "use_fp32_numerics",
    "UNet",
    "UNetResNet",
    "build_model",
    "build_unet",
    "capture_attention",
    "predict_full_image",
    "predict_image",
    "predict_tiled_ensemble",
    "segmentation_distribution",
    "uncertainty_maps",
    "convert_jax_unet",
    "convert_jax_unet_resnet",
    "load_jax_variables",
    "TrainConfig",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
]
