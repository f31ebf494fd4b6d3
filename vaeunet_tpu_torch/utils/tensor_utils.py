"""Scalar/DataFrame glue.  Port of ``vaeunet_tpu/utils/tensor_utils.py``
(reference utils/tensor_utils.py).

- to_python_scalar            <- tensor_utils.py:8
- ensure_dict_python_scalars  <- tensor_utils.py:28
- fix_dataframe_tensors       <- tensor_utils.py:54
- ensure_numeric_dataframe    <- tensor_utils.py:100

Accepts torch tensors on any device (moved to the host first, as the
reference's ``tensor_utils.py:8`` did), numpy arrays/scalars and Python
numbers.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_python_scalar(value: Any) -> Any:
    """Convert a 0-d/1-element array-like to a Python scalar; pass through
    everything else."""
    if isinstance(value, (int, float, bool, str)) or value is None:
        return value
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if hasattr(value, "item"):
        try:
            arr = np.asarray(value)
            if arr.size == 1:
                return arr.reshape(()).item()
            return arr
        except (TypeError, ValueError):
            return value
    return value


def ensure_dict_python_scalars(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: to_python_scalar(v) for k, v in d.items()}


def fix_dataframe_tensors(df):
    """Convert array-valued cells in a DataFrame to scalars where possible."""
    out = df.copy()
    for col in out.columns:
        out[col] = out[col].map(to_python_scalar)
    return out


def ensure_numeric_dataframe(df, exclude=("img_id",)):
    """Coerce all non-excluded columns to numeric (NaN on failure)."""
    import pandas as pd
    out = fix_dataframe_tensors(df)
    for col in out.columns:
        if col in exclude:
            continue
        out[col] = pd.to_numeric(out[col], errors="coerce")
    return out
