"""Clip by global norm, then AdamW, as two launches of ``csrc/clip_adamw.cu``:
the CUDA kernels' wrapper.  New in the port: the JAX package leaves optax's
``clip_by_global_norm`` and ``adamw`` to XLA, which fuses them; it has no
Pallas kernel here.

The plain version is ``ClippedAdamW.clip_`` followed by its
``torch.optim.AdamW`` (``training/state.py``), which CPU parameters take;
the kernels compute what it computes on the card, bit for bit (the clip's
``g / norm * max_norm`` and the roundings of torch's CUDA foreach AdamW,
``csrc/clip_adamw.cu``), with the norm's sums in another order.

A :class:`Plan` is the launches' tensor table and scratch for fixed lists
of parameters and their AdamW moments: it checks them, holds their
addresses, and takes each step's gradients (:meth:`Plan.set_grads`; their
addresses change every step under ``zero_grad(set_to_none=True)``) and
bias corrections (:meth:`Plan.set_scalars`).  :func:`norm` launches the norm
kernel, :func:`update` the clip and AdamW.  AdamW's state, and when a plan
is made anew, are ``ClippedAdamW``'s.

Counters: ``clip_adamw_norm`` and ``clip_adamw_update`` (one each a step),
``clip_adamw_elems`` (the elements updated).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.ops import _ext

THREADS = 256           # a block (kThreads)
CHUNK = 16384           # elements a chunk (kChunk): a block's unit of work
MAX_TENSORS = 512       # tensors a launch's table holds (kMaxTensors; the models have 104-263)
BLOCKS_PER_SM = 4       # the grid: this many blocks an SM, fewer where the chunks run out
NORM_FN = "vaeunet_clip_adamw_norm"
UPDATE_FN = "vaeunet_clip_adamw_update"


def bias_corrections(beta1: float, beta2: float, lr: float, step: float) -> Tuple[float, float]:
    """(-(lr / bc1), sqrt(bc2)) at `step`, in double, as torch's
    ``_multi_tensor_adam`` makes them (rounded to fp32 on the way in)."""
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    return (lr / bc1) * -1, bc2 ** 0.5


def dense(t: torch.Tensor) -> bool:
    """Non-overlapping and dense: the strides of the dims longer than 1 are
    a permutation of a contiguous layout's."""
    expect = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a's elements lie in memory as b's (shape and the strides of the dims
    longer than 1)."""
    return a.shape == b.shape and all(x == y for x, y, n in zip(a.stride(), b.stride(), b.shape)
                                      if n != 1)


def _sms(device: torch.device) -> int:
    """The card's SM count (the grid's measure)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_group(group: dict) -> None:
    if group["amsgrad"] or group["maximize"]:
        raise ValueError("clip_adamw: amsgrad and maximize are not in the kernels")


class Plan:
    """The table and scratch of the launches over `params` and their
    moments `exp_avgs`, `exp_avg_sqs` (the module docstring).  Raises for
    what the kernels cannot take."""

    def __init__(self, params: Sequence[torch.Tensor], exp_avgs: Sequence[torch.Tensor],
                 exp_avg_sqs: Sequence[torch.Tensor]):
        n = len(params)
        if n == 0:
            raise ValueError("clip_adamw: no parameter has a gradient")
        if n > MAX_TENSORS:
            raise ValueError(f"clip_adamw takes at most {MAX_TENSORS} tensors, not {n}")
        device = params[0].device
        self.table = np.zeros((5, n), dtype=np.int64)      # g, p, m, v, numel
        self.scalars = np.zeros((2, n), dtype=np.float32)  # -(lr / bc1), sqrt(bc2)
        for k, p in enumerate(params):
            if p.device != device:
                raise ValueError(f"clip_adamw: parameters on {device} and {p.device}")
            if p.dtype is not torch.float32:
                raise TypeError(f"clip_adamw takes float32 parameters, not {p.dtype}")
            if not dense(p):
                raise ValueError(f"clip_adamw: a parameter of strides {p.stride()} is not dense")
            for key, t in (("exp_avg", exp_avgs[k]), ("exp_avg_sq", exp_avg_sqs[k])):
                if t.dtype != p.dtype or t.device != p.device or not same_layout(t, p):
                    raise ValueError(f"clip_adamw: {key} of {t.dtype} on {t.device}, strides "
                                     f"{t.stride()}, where its parameter is {p.dtype} on "
                                     f"{p.device}, strides {p.stride()}")
            self.table[1:, k] = (p.data_ptr(), exp_avgs[k].data_ptr(),
                                 exp_avg_sqs[k].data_ptr(), p.numel())
        self.params = list(params)
        self.strides = [p.stride() for p in params]
        self.device = device
        self.count = n
        self.elems = int(self.table[4].sum())
        self.blocks = BLOCKS_PER_SM * _sms(device)
        self.partial = torch.empty(self.blocks, dtype=torch.float32, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.table_ptr = self.table.ctypes.data
        self.scalars_ptr = self.scalars.ctypes.data

    def set_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Check each gradient, one a parameter in order, and write its
        address into the table."""
        row = self.table[0]
        for k, g in enumerate(grads):
            if (g.dtype is not torch.float32 or g.device != self.device
                    or (g.stride() != self.strides[k] and not same_layout(g, self.params[k]))):
                raise ValueError(
                    f"clip_adamw: a gradient of {g.dtype} on {g.device}, strides {g.stride()}, "
                    f"where its parameter is float32 on {self.device}, strides {self.strides[k]}")
            row[k] = g.data_ptr()

    def set_scalars(self, steps: np.ndarray, beta1: float, beta2: float, lr: float) -> None:
        """Each tensor's bias corrections at its step count in `steps`."""
        lo, hi = steps.min(), steps.max()
        if lo == hi:
            self.scalars[0], self.scalars[1] = bias_corrections(beta1, beta2, lr, float(lo))
            return
        for v in np.unique(steps):
            at = steps == v
            self.scalars[0, at], self.scalars[1, at] = bias_corrections(beta1, beta2, lr, float(v))


def norm_args(plan: Plan, norm: torch.Tensor) -> tuple:
    """The norm launch's arguments, less the stream."""
    return (plan.table_ptr, plan.count, plan.partial.data_ptr(), plan.ticket.data_ptr(),
            norm.data_ptr(), plan.blocks)


def update_args(plan: Plan, norm: torch.Tensor, group: dict, max_norm: float) -> tuple:
    """The update launch's arguments, less the stream: AdamW's scalars in
    double, as torch makes them (ctypes rounds each to fp32)."""
    beta1, beta2 = group["betas"]
    lr, wd = float(group["lr"]), group["weight_decay"]
    return (plan.table_ptr, plan.scalars_ptr, plan.count, norm.data_ptr(), 1 - lr * wd,
            1 - beta1, beta2, 1 - beta2, group["eps"], max_norm, plan.blocks)


def norm(plan: Plan) -> torch.Tensor:
    """The norm launch over the table's gradients -> the norm, a fresh
    device scalar the launch writes."""
    out = torch.empty((), dtype=torch.float32, device=plan.device)
    _ext.call("clip_adamw", NORM_FN, plan.device, *norm_args(plan, out))
    _ext.count_launch("clip_adamw_norm")
    return out


def update(plan: Plan, norm: torch.Tensor, group: dict, max_norm: float) -> None:
    """The update launch: the clip by `norm` (a float32 device scalar) and
    AdamW with `group`'s hyperparameters (:func:`check_group`), in place;
    the table's scalars set for this step."""
    _ext.call("clip_adamw", UPDATE_FN, plan.device, *update_args(plan, norm, group, max_norm))
    _ext.count_launch("clip_adamw_update")
    _ext.LAUNCHES["clip_adamw_elems"] += plan.elems
