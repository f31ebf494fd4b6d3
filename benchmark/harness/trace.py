"""The device trace of a traced segment, and what the metrics read from it.

``torch.profiler`` records the device's activity alone (kernels, copies,
sets; no host operators).  Its callback on every launch still slows a
host-bound segment (the resnet34 step's by about half on the H100's host),
so the metrics take seconds an item from the untraced window and only the
device's busy time from here.  The benchmark's own host spans around its
calls into the program are taken with ``time.time_ns()``, the clock the
profiler's events are stamped in.

- busy: the union of the device intervals inside the window (not their
  sum, which counts twice what overlaps on two streams);
- idle gaps: the stretches of the window outside that union, each named
  by the host span that holds its middle (``between_calls`` where none);
- device operations by name, and by family (a copy of the family table of
  ``vaeunet_tpu_torch/utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("conv_bn_stats", ("conv3x3_stats_f32_kernel", "conv3x3_stats_wgmma_kernel",
                       "conv3x3_stats_ci8_kernel", "reduce_partials_kernel")),
    ("bn_relu", ("bn_relu_",)),
    ("resize_bwd", ("resize_bwd_tiled_kernel", "resize_row_bwd_kernel",
                    "resize_bilinear_bwd_kernel")),
    ("resize", ("resize_tiled_kernel", "resize_row_kernel", "resize_bilinear_kernel")),
    ("normal/reparam", ("normal_kernel", "reparam_kernel")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("batch_norm", ("batch_norm", "bn_fw_inf")),
    ("convolution (cuDNN)", ("conv", "xmma", "cudnn", "implicit_gemm", "cutlass", "sm90_",
                             "winograd", "fft", "DSE::", "pointwise_mult_and_sum_complex",
                             "gemm", "nchwToNhwc", "nhwcToNchw")),
    ("copy / cat / fill", ("copy", "Cat", "cat_", "fill", "Memcpy", "Memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other elementwise / reduction"


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(event, f"{what}_us")() * 1000)


def union_intervals(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Tracer:
    """``with tracer.window(): ... with tracer.span("step"): ...`` records
    the device's activity over the window and the host spans inside it."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self.events: List[Tuple[str, int, int]] = []      # (name, start, end) in ns
        self.start_ns = self.end_ns = 0

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        self.start_ns = time.time_ns()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.end_ns = time.time_ns()
            prof.stop()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            start = _ns(e, "start")
            self.events.append((e.name(), start, start + _ns(e, "duration")))

    # ----- readings -----------------------------------------------------

    def inside(self) -> List[Tuple[str, int, int]]:
        return [(n, max(a, self.start_ns), min(b, self.end_ns)) for n, a, b in self.events
                if b > self.start_ns and a < self.end_ns]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_s(self) -> float:
        return sum(b - a for a, b in union_intervals([(a, b) for _, a, b in self.inside()])) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        """Device events that are kernels: not copies, not sets."""
        return [e for e in self.inside() if not e[0].startswith(("Memcpy", "Memset"))]

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, a, b in self.inside():
            out[n] += (b - a) * 1e-9
        return dict(out)

    def seconds_by_family(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s in self.seconds_by_name().items():
            out[family(n)] += s
        return dict(out)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds of the window by what the host was doing, largest first."""
        busy = union_intervals([(a, b) for _, a, b in self.inside()])
        edges = [self.start_ns] + [t for iv in busy for t in iv] + [self.end_ns]
        out: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = next((s for s, s0, s1 in self.spans if s0 <= mid <= s1), "between_calls")
            out[name] += (b - a) * 1e-9
        return sorted(out.items(), key=lambda kv: -kv[1])

    def aligned(self) -> bool:
        """Whether the two clocks agree: the profile starts and stops on an
        idle device, so every device event lies inside the window."""
        total = sum(b - a for _, a, b in self.events)
        return total > 0 and sum(b - a for _, a, b in self.inside()) >= 0.99 * total
