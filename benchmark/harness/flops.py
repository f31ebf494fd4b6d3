"""Operations and bytes the metrics divide by, counted on the reference.

Matrix and convolution FLOPs come from ``torch.utils.flop_counter``
running the reference on the meta device at the cell's shapes (forward,
and backward where the step has one; a backward counts only the
gradients that autograd computes, so nothing recomputed is counted).
The 3x3 sites are the stride-1, pad-1, bias-free 3x3 convolutions, each
followed by a BN: the convolutions that the program's fused conv + BN
statistics kernel computes in training.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.peaks import bound_s
from benchmark.reference.layers import Conv

BYTES = {"bf16": 2, "fp16": 2, "fp32": 4}


def count(fn: Callable[[], object]) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def conv3x3_sites(model: nn.Module, run: Callable[[], object]) -> List[Tuple[int, int, int, int, int]]:
    """(N, Ci, H, W, Co) of every 3x3 site that ``run()`` passes through."""
    sites = []

    def hook(m, inputs, _out):
        n, ci, h, w = inputs[0].shape
        sites.append((int(n), int(ci), int(h), int(w), int(m.weight.shape[0])))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv) and not m.transposed and m.weight.shape[2:] == (3, 3)
               and m.stride == 1 and m.padding == 1 and m.bias is None]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return sites


def conv3x3_ops_bytes(site, precision: str) -> Tuple[float, float]:
    """A site's operations and its bytes, each input, weight and output
    byte counted once, plus the two float32 statistics vectors."""
    n, ci, h, w, co = site
    e = BYTES[precision]
    ops = 2.0 * n * h * w * co * ci * 9
    nbytes = e * (n * h * w * ci + 9 * ci * co + n * h * w * co) + 8 * co
    return ops, nbytes


def conv3x3_bound_s(sites, precision: str) -> float:
    return sum(bound_s(*conv3x3_ops_bytes(s, precision), precision) for s in sites)
