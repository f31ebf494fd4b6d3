"""Reference ``.pth`` checkpoints.  Port of
``vaeunet_tpu/compat/torch_weights.py``, holding only
``load_reference_checkpoint`` (``:153-168``).

The port's models use the reference's state-dict names, so a reference
checkpoint (train.py:542-565: a dict with ``model_state_dict`` and
``params``, or a bare state dict) needs no conversion: its state dict goes
into ``load_state_dict`` as it is.  The JAX package's flax converters have
no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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

