"""JAX/flax -> PyTorch weight conversion for the VAE-UNet and the plain
UNet.  New in the port: the inverse of ``vaeunet_tpu/compat/torch_weights.py``.

A flax ``{'params', 'batch_stats'}`` tree of arrays (numpy, or anything
``np.asarray`` reads) goes in; the port's ``state_dict`` comes out:

- conv kernels HWIO -> OIHW, biases as they are; the plain UNet's
  transposed-conv kernels (kh, kw, out, in) -> (in, out, kh, kw), the
  inverse of ``_conv_with_bias(..., transpose_conv=True)``, which is the
  same axis permutation;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var`` (plus ``num_batches_tracked`` = 0);
- flax names -> the reference names (``layer1_0`` -> ``layer1.0``,
  ``W_g_conv`` -> ``W_g.0``, ``decoder_0`` -> ``decoder_blocks.0``,
  ``ds_head_0`` -> ``ds_heads.0``, ``inc/conv1`` -> ``inc.double_conv.0``,
  ...).

The encoder's stage sizes and block kind are read from the tree, so
resnet18/34/50/101 trees all convert.  Only submodules present in the tree
are emitted (flax creates a submodule's parameters only when it is used).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.models.unet import UNet


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


def _block(sd: Dict, p: Mapping, s: Mapping, prefix: str) -> None:
    """One residual block: conv1/bn1, conv2/bn2, a bottleneck's conv3/bn3,
    and the downsample where the block has one."""
    for i in (1, 2, 3):
        if f"conv{i}" in p:
            _conv(sd, p[f"conv{i}"], f"{prefix}.conv{i}")
            _bn(sd, p[f"bn{i}"], s[f"bn{i}"], f"{prefix}.bn{i}")
    if "downsample_conv" in p:
        _conv(sd, p["downsample_conv"], f"{prefix}.downsample.0")
        _bn(sd, p["downsample_bn"], s["downsample_bn"], f"{prefix}.downsample.1")


def _encoder(sd: Dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    _conv(sd, params["conv1"], f"{prefix}conv1")
    _bn(sd, params["bn1"], stats["bn1"], f"{prefix}bn1")
    for si, n_blocks in enumerate(stage_sizes(params)):
        for bi in range(n_blocks):
            name = f"layer{si + 1}_{bi}"
            _block(sd, params[name], stats[name], f"{prefix}layer{si + 1}.{bi}")


def convert_jax_pretrain(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of a pretext model of ``vaeunet_tpu/training/
    pretrain.py`` -> state_dict of its port (``training/pretrain.py``):
    ``MaskedReconstructor`` (``head_conv{i}`` -> ``head_convs.{i}``,
    ``head_bn{i}`` -> ``head_bns.{i}``, ``head_out``) or
    ``ContrastiveProjector`` (``proj1`` / ``proj2``: Dense kernels [in, out]
    -> Linear weights [out, in])."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params["encoder"], stats["encoder"], "encoder.")
    i = 0
    while f"head_conv{i}" in params:
        _conv(sd, params[f"head_conv{i}"], f"head_convs.{i}")
        _bn(sd, params[f"head_bn{i}"], stats[f"head_bn{i}"], f"head_bns.{i}")
        i += 1
    if "head_out" in params:
        _conv(sd, params["head_out"], "head_out")
    for name in ("proj1", "proj2"):
        if name in params:
            sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
            sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd


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
    for i in range(3):
        if f"ds_head_{i}" in params:
            _conv(sd, params[f"ds_head_{i}"], f"ds_heads.{i}")
    return sd


def _double_conv(sd: Dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    for i, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        _conv(sd, params[conv], f"{prefix}.double_conv.{3 * i}")
        _bn(sd, params[bn], stats[bn], f"{prefix}.double_conv.{3 * i + 1}")


def convert_jax_unet(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of ``vaeunet_tpu.models.UNet`` -> state_dict of
    ``vaeunet_tpu_torch.models.UNet`` (either ``bilinear`` setting: the
    transposed convs ``up{i}/up`` are emitted where the tree has them)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _double_conv(sd, params["inc"], stats["inc"], "inc")
    for i in range(1, 5):
        _double_conv(sd, params[f"down{i}"]["conv"], stats[f"down{i}"]["conv"],
                     f"down{i}.maxpool_conv.1")
    for i in range(1, 5):
        p, s = params[f"up{i}"], stats[f"up{i}"]
        if "up" in p:
            _conv(sd, p["up"], f"up{i}.up")
        for part in ("W_g", "W_x", "psi"):
            _conv(sd, p["attention"][f"{part}_conv"], f"up{i}.attention.{part}.0")
            _bn(sd, p["attention"][f"{part}_bn"], s["attention"][f"{part}_bn"],
                f"up{i}.attention.{part}.1")
        _double_conv(sd, p["conv"], s["conv"], f"up{i}.conv")
    _conv(sd, params["outc"]["conv"], "outc.conv")
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> list:
    """Load converted flax variables into `model`, by the converter of its
    kind (a port ``UNet``, else the VAE-UNet's).  Raises on a name the model
    lacks; returns the model's keys the tree did not cover."""
    convert = convert_jax_unet if isinstance(model, UNet) else convert_jax_unet_resnet
    result = model.load_state_dict(convert(variables), strict=False)
    if result.unexpected_keys:
        raise KeyError(f"names not in the model: {result.unexpected_keys}")
    return list(result.missing_keys)
