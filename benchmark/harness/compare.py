"""The numbers that decide ``correct``, and the judgement against limits.

Training (program and reference each give the dictionary of
``reference/train.py::follow``):

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the checked steps;
- ``grad_median_gap``: each leaf's gap between the program's and the
  reference's norm of the first step's gradient as the optimizer gets it,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger; the median over the leaves.  Not the worst leaf: in bf16 the
  worst leaf is the one whose gradient sums the most cancelling terms (the
  stem BN's shift, the first conv's weight), and it reads 0.13 to 0.5 on
  every seed from the precision's rounding alone (``PERF.md``);
- ``change_gap``: the worst leaf's gap, measured so, of the norm of each
  leaf's change after the checked steps, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (the others, such
  as a conv bias under a batch-statistics BN, move under AdamW by
  round-off alone).

Serving: the widest absolute gap of each output against the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from benchmark.harness.stats import median

MOVING_LEAF = 1e-3


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float], leaves) -> List[float]:
    floor = median([ref[n] for n in leaves])
    return [abs(prog[n] - ref[n]) / max(ref[n], floor) for n in leaves]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    if set(prog["grad"]) != set(ref["grad"]):
        raise KeyError("the program's leaves are not the reference's")
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad"])
    gmed = median([ref["grad"][n] for n in leaves])
    moving = [n for n in leaves if ref["grad"][n] >= MOVING_LEAF * gmed]
    return {"loss_gap": loss_gap,
            "grad_median_gap": median(leaf_gaps(prog["grad"], ref["grad"], leaves)),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"], moving))}


def widest_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().reshape(b.shape), b.float()
    gap = (a - b).abs()
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float(gap.max())


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """-> (every number within its limit, [(name, number, limit)])."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    checks = [(k, float(numbers[k]), float(limits[k])) for k in sorted(limits)]
    return all(v <= lim for _, v, lim in checks), checks
