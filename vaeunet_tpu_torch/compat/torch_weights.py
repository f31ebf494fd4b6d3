"""Reference ``.pth`` checkpoints and torchvision/timm backbones.  Port of
``vaeunet_tpu/compat/torch_weights.py``: ``load_reference_checkpoint``
(``:153-168``) and ``convert_resnet34_backbone`` (``:144-150``).

The port's models use the reference's state-dict names, so a reference
checkpoint (train.py:542-565: a dict with ``model_state_dict`` and
``params``, or a bare state dict) needs no conversion: its state dict goes
into ``load_state_dict`` as it is.  The JAX package's flax converters of
the whole models have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """-> (state_dict on the host, the checkpoint's ``params`` metadata or
    {}); the milesial ``mask_values`` entry is dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
        meta = ckpt.get("params", {}) or {}
    else:
        sd, meta = ckpt, {}
    return {k: v for k, v in sd.items() if k != "mask_values"}, dict(meta)



def convert_resnet34_backbone(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision/timm resnet34 (classification) state dict -> the state
    dict of a standalone ``models.ResNetEncoder(backbone='resnet34')``: the
    stem, the four stages and their downsamples keep their names (the
    reference's are torchvision's); the classifier ``fc`` is dropped.
    Raises on a name the encoder lacks or a missing one."""
    from vaeunet_tpu_torch.models.resnet import ResNetEncoder

    want = ResNetEncoder(backbone="resnet34").state_dict()
    out = {k: torch.as_tensor(v) for k, v in sd.items() if not k.startswith("fc.")}
    extra = sorted(set(out) - set(want))
    missing = sorted(k for k in set(want) - set(out) if not k.endswith("num_batches_tracked"))
    if extra or missing:
        raise KeyError(f"not a resnet34 state dict: unknown {extra[:5]}, missing {missing[:5]}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, resnet34 has {tuple(want[k].shape)}")
    return out
