"""JAX/flax -> PyTorch weight conversion for the VAE-UNet.  New in the port:
the inverse of ``vaeunet_tpu/compat/torch_weights.py``.

A flax ``{'params', 'batch_stats'}`` tree of arrays (numpy, or anything
``np.asarray`` reads) goes in; the port's ``state_dict`` comes out:

- conv kernels HWIO -> OIHW, biases as they are;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var`` (plus ``num_batches_tracked`` = 0);
- flax names -> the reference names (``layer1_0`` -> ``layer1.0``,
  ``W_g_conv`` -> ``W_g.0``, ``decoder_0`` -> ``decoder_blocks.0``, ...).

The encoder's stage sizes are read from the tree, so resnet18 and resnet34
trees both convert.  Only submodules present in the tree are emitted (flax
creates a submodule's parameters only when it is used).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: Dict, params: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in params:
        sd[f"{prefix}.bias"] = _t(params["bias"])


def _bn(sd: Dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def stage_sizes(encoder_params: Mapping) -> Tuple[int, ...]:
    """Blocks per stage, read from the encoder's ``layer{s}_{b}`` names."""
    counts: Dict[int, int] = {}
    for name in encoder_params:
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            counts[s] = max(counts.get(s, 0), b + 1)
    return tuple(counts[s] for s in sorted(counts))


def _encoder(sd: Dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    _conv(sd, params["conv1"], f"{prefix}conv1")
    _bn(sd, params["bn1"], stats["bn1"], f"{prefix}bn1")
    for si, n_blocks in enumerate(stage_sizes(params)):
        for bi in range(n_blocks):
            name = f"layer{si + 1}_{bi}"
            p, s = params[name], stats[name]
            tp = f"{prefix}layer{si + 1}.{bi}"
            _conv(sd, p["conv1"], f"{tp}.conv1")
            _bn(sd, p["bn1"], s["bn1"], f"{tp}.bn1")
            _conv(sd, p["conv2"], f"{tp}.conv2")
            _bn(sd, p["bn2"], s["bn2"], f"{tp}.bn2")
            if "downsample_conv" in p:
                _conv(sd, p["downsample_conv"], f"{tp}.downsample.0")
                _bn(sd, p["downsample_bn"], s["downsample_bn"], f"{tp}.downsample.1")


def convert_jax_unet_resnet(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of ``vaeunet_tpu.models.UNetResNet`` -> state_dict of
    ``vaeunet_tpu_torch.models.UNetResNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params["encoder"], stats["encoder"], "encoder.")
    _conv(sd, params["mu_conv"], "mu_head.0")
    _conv(sd, params["logvar_conv"], "logvar_head.0")
    if "z_initial_conv" in params:
        _conv(sd, params["z_initial_conv"], "z_initial.0")
        _bn(sd, params["z_initial_bn"], stats["z_initial_bn"], "z_initial.1")
    for i in range(4):
        p, s = params[f"decoder_{i}"], stats[f"decoder_{i}"]
        tp = f"decoder_blocks.{i}"
        if "z_proj_conv" in p:
            _conv(sd, p["z_proj_conv"], f"{tp}.z_proj.0")
            _bn(sd, p["z_proj_bn"], s["z_proj_bn"], f"{tp}.z_proj.1")
        if "attention" in p:
            pa, sa = p["attention"], s["attention"]
            for part in ("W_g", "W_x", "psi"):
                _conv(sd, pa[f"{part}_conv"], f"{tp}.attention.{part}.0")
                _bn(sd, pa[f"{part}_bn"], sa[f"{part}_bn"], f"{tp}.attention.{part}.1")
        for ci in (1, 2):
            _conv(sd, p[f"conv{ci}"], f"{tp}.conv{ci}.0")
            _bn(sd, p[f"bn{ci}"], s[f"bn{ci}"], f"{tp}.conv{ci}.1")
    _conv(sd, params["final_conv"], "final_conv")
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> list:
    """Load converted flax variables into `model`.  Raises on a name the
    model lacks; returns the model's keys the tree did not cover."""
    result = model.load_state_dict(convert_jax_unet_resnet(variables), strict=False)
    if result.unexpected_keys:
        raise KeyError(f"names not in the model: {result.unexpected_keys}")
    return list(result.missing_keys)
