"""Checkpoint loading for every CLI.  Port of
``vaeunet_tpu/compat/loading.py`` (``load_model_and_variables``, ``:22-70``).

Accepts a reference ``.pth`` file (train.py:542-565 format or a bare state
dict), a run directory of this package (``training/checkpoint.py``), or a
run directory of the JAX package exported by
``scripts/export_jax_checkpoint.py``, rebuilds the model from the stored
hyperparameters, and returns ``(model, config)``: the port's model carries
its own weights.

A run directory of the JAX package holds an orbax checkpoint, which only
orbax can read, and orbax imports jax; this package never imports jax.  The
export script (run where the JAX package is installed) writes the run's
flax variables beside its ``config.json`` as ``jax_variables.npz``, arrays
under their '/'-joined tree paths, which this module converts with numpy
(``compat/jax_weights.py``).  A JAX run dir without that file is refused
with ``NotImplementedError`` naming the command.  The same holds for a
pretrained encoder (:func:`load_encoder_state`): ``cli.pretrain``'s
``encoder.pt`` loads, and so does the ``encoder.npz`` the export script
writes from the JAX pretraining script's orbax ``encoder`` directory.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.compat.jax_weights import (
    convert_jax_pretrain,
    convert_jax_unet,
    convert_jax_unet_resnet,
)
from vaeunet_tpu_torch.compat.torch_weights import load_reference_checkpoint
from vaeunet_tpu_torch.training.checkpoint import is_checkpoint, load_config, load_model_state
from vaeunet_tpu_torch.training.config import TrainConfig

log = logging.getLogger(__name__)

# reference ``params`` entry -> TrainConfig field  (loading.py:39-52)
_META_FIELDS = {"lesion_type": "lesion_type", "patch_size": "patch_size",
                "img_scale": "img_scale", "beta": "beta", "free_bits": "free_bits",
                "kl_anneal_epochs": "kl_anneal_epochs",
                "latent_injection": "latent_injection",
                "use_attention": "use_attention", "seed": "seed"}

# what scripts/export_jax_checkpoint.py writes
JAX_VARIABLES = "jax_variables.npz"
JAX_ENCODER = "encoder.npz"
EXPORT_COMMAND = "python scripts/export_jax_checkpoint.py"


def read_flat_npz(path: Path) -> Dict[str, Any]:
    """An ``.npz`` of '/'-joined tree paths -> the nested dict of arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for name in z.files:
            node = tree
            *parents, leaf = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = z[name]
    return tree


def load_state(path: str, overrides: Optional[Dict[str, Any]] = None
               ) -> Tuple[Dict[str, torch.Tensor], TrainConfig]:
    """-> (state dict on the host, config) of a checkpoint.

    The checkpoint's own metadata wins (state-dict keys and stored params
    for a ``.pth``, config.json for a run dir); `overrides` act as
    fallbacks for fields the checkpoint does not record (e.g. the CLI's
    --latent-injection on a bare state dict)."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    if p.is_file():
        sd, meta = load_reference_checkpoint(str(p))
        cfg_kwargs: Dict[str, Any] = {}
        for src, dst in _META_FIELDS.items():
            if meta.get(src) is not None:
                cfg_kwargs[dst] = meta[src]
        if meta.get("model_type"):
            cfg_kwargs["model_type"] = "resnet" if meta["model_type"] == "resnet" else "basic"
        # the VAE-UNet's keys carry its encoder; a plain UNet upsamples
        # bilinearly when it has no transposed-conv weights
        # (torch_weights.py:164,168 of the JAX package)
        is_resnet = any(k.startswith("encoder.") for k in sd)
        cfg_kwargs.setdefault("model_type", "resnet" if is_resnet else "basic")
        if cfg_kwargs["model_type"] == "basic":
            cfg_kwargs["bilinear"] = not any(".up.weight" in k for k in sd)
        config = TrainConfig(**{**(overrides or {}), **cfg_kwargs})
        log.info("Loaded reference checkpoint %s (%s)", path, config.model_type)
        return sd, config
    if is_checkpoint(str(p)):
        config = load_config(str(p)) or TrainConfig(**(overrides or {}))
        log.info("Loaded checkpoint %s (%s)", path, config.model_type)
        return load_model_state(str(p)), config
    if (p / JAX_VARIABLES).is_file():
        config = load_config(str(p)) or TrainConfig(**(overrides or {}))
        convert = convert_jax_unet_resnet if config.model_type == "resnet" else convert_jax_unet
        log.info("Loaded exported JAX checkpoint %s (%s)", path, config.model_type)
        return convert(read_flat_npz(p / JAX_VARIABLES)), config
    raise NotImplementedError(
        f"{path} is neither a run dir of this package (no best/state.pt) nor an exported "
        f"JAX run dir (no {JAX_VARIABLES}); a JAX run dir holds an orbax checkpoint, which "
        "needs orbax and therefore jax, and vaeunet_tpu_torch never imports jax: export it "
        f"where the JAX package is installed with `{EXPORT_COMMAND} {path}`")


def load_model(path: str, overrides: Optional[Dict[str, Any]] = None,
               device=None) -> Tuple[torch.nn.Module, TrainConfig]:
    """-> (model in eval mode on `device`, config): :func:`load_state`
    into the config's model, strictly (every key, no extra one).  `device`:
    CUDA unless ``"cpu"``."""
    from vaeunet_tpu_torch.training.state import build_model

    sd, config = load_state(path, overrides)
    model = build_model(config, device=device)
    model.load_state_dict(sd)
    return model.eval(), config


def load_encoder_state(path: str) -> Dict[str, torch.Tensor]:
    """The encoder state (``encoder.*`` entries) that ``cli.pretrain``
    wrote, ``<path>/encoder.pt`` (or `path` itself when it is that file),
    or that the export script wrote from a JAX encoder directory,
    ``<path>/encoder.npz``.  A JAX encoder directory (``<path>/encoder``,
    orbax) that was not exported is refused."""
    p = Path(path)
    f = p if p.is_file() else p / "encoder.pt"
    if f.is_file():
        return torch.load(f, map_location="cpu", weights_only=True)
    if (p / JAX_ENCODER).is_file():
        return convert_jax_pretrain(read_flat_npz(p / JAX_ENCODER))
    if (p / "encoder").is_dir():
        raise NotImplementedError(
            f"{p / 'encoder'} is an orbax checkpoint of the JAX package's pretraining "
            "script, which needs orbax and therefore jax, and vaeunet_tpu_torch never "
            "imports jax: export it where the JAX package is installed with "
            f"`{EXPORT_COMMAND} --encoder {p}`, or pretrain with python -m "
            "vaeunet_tpu_torch.cli.pretrain")
    raise FileNotFoundError(f"no pretrained encoder at {path} (expected {f})")
