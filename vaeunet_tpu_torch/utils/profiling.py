"""Profiling and memory observability.  Port of
``vaeunet_tpu/utils/profiling.py``:

- :func:`device_memory_mb`   live device memory (``torch.cuda.memory_allocated``),
                             None on the CPU
- :func:`log_memory_usage`   host RSS and device memory (analyze_model.py:38-45)
- :func:`track_memory`       decorator logging the host/device memory deltas and
                             the time around a call (visualize_vae.py:22-46)
- :func:`time_fn`            mean seconds a call, each window ended by
                             ``torch.cuda.synchronize()`` or a host fetch
- :func:`trace`              ``torch.profiler`` over a block, written as a Chrome
                             trace (Perfetto, chrome://tracing)

and, new in the port, where a serving request's or a training step's
device time goes:

    python -m vaeunet_tpu_torch.utils.profiling            # one request
    python -m vaeunet_tpu_torch.utils.profiling --train    # one train step
    python -m vaeunet_tpu_torch.utils.profiling --train --fp32   # ... with amp=False
    python -m vaeunet_tpu_torch.utils.profiling --train --model unet   # another model

runs, after a warm-up, one N-sample uncertainty request (the
full-resolution tiled request of ``chip_smoke.py``), or one warm training
step (the 512^2 batch-16 bf16 step of ``chip_smoke.py`` phase 6, or with
``--fp32`` its fp32 form with TF32 off, phase 7; ``--model`` picks the
resnet34 VAE-UNet, the plain UNet of either ``bilinear`` setting or the
resnet50 VAE-UNet with deep supervision, phases 10 and 11), under
``torch.profiler`` on the card and prints the device time by kernel family
and the top kernels, the wall time, the device's idle share (1 - the union
of the device intervals / wall time), and, by program span, the host
milliseconds and the device's idle milliseconds.  Needs a CUDA card.

The program's spans (:func:`span`) mark its layer boundaries: the train
step's phases (``train.*``: ``training/step.py``, ``training/state.py``)
and the tiled request's stages (``serve.*``: ``inference/predict.py``,
``inference/tiled.py``).  A span is recorded only while a
``torch.profiler`` session runs, in memory, stamped with
``time.time_ns()``, the clock of the profiler's device events; otherwise
entering one costs a read of the profiler's own flag.  :func:`spans`
returns what was recorded as :class:`Span` tuples: every span of one step
or request carries the index of its outermost span as ``root``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import functools
import itertools
import json
import logging
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

log = logging.getLogger(__name__)

SPAN_LIMIT = 1 << 16                 # spans kept; past it the oldest go first


class Span(NamedTuple):
    index: int                       # the order the spans opened in
    name: str
    start_ns: int                    # time.time_ns()
    end_ns: int
    parent: int                      # the enclosing span's index, -1 for a root
    root: int                        # the outermost enclosing span's index (a root's own)


_SPANS: "collections.deque[tuple]" = collections.deque(maxlen=SPAN_LIMIT)   # Span fields
_OPEN = threading.local()            # .stack: [(index, root)] of the thread's open spans
_INDEX = itertools.count()           # the spans' indices (next() is atomic)
_OFF = contextlib.nullcontext()


class _Recorded:
    __slots__ = ("name", "index", "parent", "root", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.index = next(_INDEX)
        self.parent, self.root = stack[-1] if stack else (-1, self.index)
        stack.append((self.index, self.root))
        self.start_ns = time.time_ns()

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append((self.index, self.name, self.start_ns, end_ns, self.parent, self.root))


def span(name: str):
    """``with span("train.forward"): ...`` records the block while a
    ``torch.profiler`` session runs, and is a no-op otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name)


def spans() -> List[Span]:
    """The recorded spans (the last ``SPAN_LIMIT``), in the order they opened."""
    return [Span(*s) for s in sorted(_SPANS)]


def clear_spans() -> None:
    _SPANS.clear()


def _host_rss_mb() -> float:
    try:
        import psutil
        return psutil.Process().memory_info().rss / 1e6
    except ImportError:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return float(line.split()[1]) / 1e3
        except OSError:
            pass
        return float("nan")


def device_memory_mb(device=None) -> Optional[float]:
    """Live device memory in MB (``torch.cuda.memory_allocated``) of
    `device` (default: the current CUDA device); None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e6


def log_memory_usage(prefix: str = "") -> None:
    """(analyze_model.py:38-45)"""
    dev = device_memory_mb()
    dev_s = f", device {dev:.0f}MB" if dev is not None else ""
    log.info("%s host RSS %.0fMB%s", prefix, _host_rss_mb(), dev_s)


def track_memory(fn: Callable) -> Callable:
    """Decorator logging host/device memory deltas and the time around
    `fn` (visualize_vae.py:22-46)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        before_h, before_d = _host_rss_mb(), device_memory_mb()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        after_h, after_d = _host_rss_mb(), device_memory_mb()
        dev_s = ""
        if before_d is not None and after_d is not None:
            dev_s = f", device {before_d:.0f}->{after_d:.0f}MB"
        log.info("[%s] %.2fs, host RSS %.0f->%.0fMB%s",
                 fn.__name__, dt, before_h, after_h, dev_s)
        return result

    return wrapper


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace") -> Iterator[str]:
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a card) -> yields the path of the Chrome trace it writes,
    ``<log_dir>/trace.json``, when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    out = path / "trace.json"
    prof = profile(activities=activities)
    prof.start()
    try:
        yield str(out)
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out))
        log.info("profiler trace written to %s", out)


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _finish(out: Any) -> None:
    """Wait for `out`: ``torch.cuda.synchronize()`` for a CUDA result, else
    a host fetch of one value of its first tensor."""
    t = _first_tensor(out)
    if t is None:
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    else:
        t.detach().reshape(-1)[:1].tolist()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            fetch: Callable[[Any], None] = _finish, **kwargs) -> float:
    """Mean seconds a call of ``fn(*args, **kwargs)`` over `iters` calls
    after `warmup`, each window ended by `fetch` of the last result."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if warmup:
        fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    fetch(out)
    return (time.perf_counter() - t0) / iters


# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("conv_bn_stats (this port's kernel)", ("conv3x3_stats_f32_kernel",
                                            "conv3x3_stats_wgmma_kernel",
                                            "conv3x3_stats_ci8_kernel",
                                            "reduce_partials_kernel")),
    ("bn_relu", ("bn_relu_",)),
    ("bn_train (this port's kernel)", ("bn_train_",)),
    ("resize_bwd (this port's kernel)", ("resize_bwd_tiled_kernel", "resize_row_bwd_kernel",
                                         "resize_bilinear_bwd_kernel")),
    ("resize", ("resize_tiled_kernel", "resize_row_kernel", "resize_bilinear_kernel")),
    ("normal/reparam", ("normal_kernel", "reparam_kernel")),
    ("optimizer (foreach AdamW, clip)", ("multi_tensor_apply", "adam")),
    ("batch_norm (gate, residual)", ("batch_norm", "bn_fw_inf")),
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


def union_intervals(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_by_span(busy: List[Tuple[int, int]], start_ns: int, end_ns: int,
                 recorded: List[Span]) -> Dict[int, int]:
    """Idle nanoseconds of [start_ns, end_ns] outside the merged `busy`
    intervals that each span holds as the innermost open span: the idle
    time inside it less the idle time inside its children (one thread's
    spans nest, so its children do not overlap)."""
    gaps, t = [], start_ns
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end_ns > t:
        gaps.append((t, end_ns))
    starts = [a for a, _ in gaps]
    before = [0]
    for a, b in gaps:
        before.append(before[-1] + b - a)

    def idle_until(t: int) -> int:
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return 0
        a, b = gaps[k]
        return before[k] + min(t, b) - a

    out = {s.index: idle_until(s.end_ns) - idle_until(s.start_ns) for s in recorded}
    for s in recorded:
        if s.parent in out:
            out[s.parent] -= idle_until(s.end_ns) - idle_until(s.start_ns)
    return out


def device_breakdown(fn: Callable[[], None]) -> Dict:
    """Run fn() once under torch.profiler; -> wall seconds, device busy
    seconds (the union of the device intervals: streams may overlap),
    per-family and per-kernel device seconds and launch counts, and by
    program span name [calls, host seconds, device idle seconds it holds
    as the innermost span]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    clear_spans()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    finally:
        prof.stop()
    per_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.profiler.kineto_results.events():
        # annotation spans on the device timeline (e.g. Optimizer.step)
        # cover kernels counted on their own; they are not kernels
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        a = e.start_ns()
        intervals.append((a, a + e.duration_ns()))
        rec = per_kernel[e.name()]
        rec[0] += e.duration_ns() * 1e-9
        rec[1] += 1
    per_family = defaultdict(lambda: [0.0, 0])
    for name, (sec, n) in per_kernel.items():
        rec = per_family[family(name)]
        rec[0] += sec
        rec[1] += n
    busy = union_intervals([(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    wall = (t1 - t0) * 1e-9
    recorded = [s for s in spans() if s.start_ns >= t0 and s.end_ns <= t1]
    idle = idle_by_span(busy, t0, t1, recorded)
    per_span = defaultdict(lambda: [0, 0.0, 0.0])
    for s in recorded:
        rec = per_span[s.name]
        rec[0] += 1
        rec[1] += (s.end_ns - s.start_ns) * 1e-9
        rec[2] += idle[s.index] * 1e-9
    return {"wall_s": wall, "device_s": busy_s,
            "idle_share": 1.0 - busy_s / wall if wall > 0 else None,
            "families": dict(per_family), "kernels": dict(per_kernel),
            "spans": dict(per_span)}


def serving_request() -> Callable[[], None]:
    from vaeunet_tpu_torch import build_model, segmentation_distribution, uncertainty_maps

    model = build_model(seed=0, device="cuda")
    # one IDRiD fundus at full resolution; 512 tiles, overlap 100, N=10
    image = torch.rand((2848, 4288, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(4))

    def request():
        samples, _, _ = segmentation_distribution(
            model, image, torch.Generator().manual_seed(0), num_samples=10,
            patch_size=512, overlap=100)
        uncertainty_maps(samples)

    return request


# --model -> the config fields of its step
MODELS = {
    "vaeunet": dict(model_type="resnet"),
    "unet": dict(model_type="basic"),
    "unet_bilinear": dict(model_type="basic", bilinear=True),
    "resnet50_ds": dict(model_type="resnet", backbone="resnet50", deep_supervision=True),
}


def train_step(amp: bool = True, model: str = "vaeunet") -> Callable[[], None]:
    from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    config = TrainConfig(batch_size=16, gradient_accumulation_steps=1, amp=amp,
                         patch_size=512, learning_rate=1e-4, **MODELS[model])
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((16, 512, 512, 3), device="cuda", generator=g)
    masks = (torch.rand((16, 512, 512, 1), device="cuda", generator=g) > 0.9).float()

    def run():
        _, aux = step(state, images, masks, 0.001)
        aux["loss"].item()

    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train", action="store_true",
                        help="profile one warm 512^2 batch-16 bf16 training step")
    parser.add_argument("--fp32", action="store_true",
                        help="with --train: amp=False and TF32 off, the fp32 conv kernel's path")
    parser.add_argument("--model", choices=sorted(MODELS), default="vaeunet",
                        help="with --train: the model of the step (default the resnet34 "
                             "VAE-UNet)")
    args = parser.parse_args()
    if (args.fp32 or args.model != "vaeunet") and not args.train:
        parser.error("--fp32 and --model go with --train")
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    if args.fp32:
        from vaeunet_tpu_torch import use_fp32_numerics

        use_fp32_numerics()
    fn = train_step(amp=not args.fp32, model=args.model) if args.train else serving_request()
    fn()                                           # warm-up: library load, cuDNN plans
    if args.train:
        fn()
    out = device_breakdown(fn)
    what = (f"{'fp32 (TF32 off)' if args.fp32 else 'bf16'} {args.model} train step, 512^2 "
            f"batch 16" if args.train else "fp32 request, TF32 off")
    print(f"device: {torch.cuda.get_device_name(0)}  ({what})")
    print(f"wall {out['wall_s']:.3f} s  device busy {out['device_s']:.3f} s  "
          f"idle share {out['idle_share']:.3f}")
    for fam, (sec, n) in sorted(out["families"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:30s} {sec * 1e3:10.1f} ms  {100 * sec / out['device_s']:5.1f} %  "
              f"{n} launches")
    print("top kernels:")
    top = sorted(out["kernels"].items(), key=lambda kv: -kv[1][0])[:12]
    for name, (sec, n) in top:
        print(f"  {sec * 1e3:10.1f} ms  {n:6d}x  {name[:110]}")
    print("program spans (host ms, device idle ms held as the innermost span):")
    for name, (n, host, idle) in sorted(out["spans"].items(), key=lambda kv: -kv[1][2]):
        print(f"  {name:20s} {n:4d}x  host {host * 1e3:9.2f} ms  idle {idle * 1e3:8.2f} ms")
    print(json.dumps({"wall_s": out["wall_s"], "device_s": out["device_s"],
                      "idle_share": out["idle_share"],
                      "families_ms": {k: v[0] * 1e3 for k, v in out["families"].items()},
                      "span_host_ms": {k: v[1] * 1e3 for k, v in out["spans"].items()},
                      "span_idle_ms": {k: v[2] * 1e3 for k, v in out["spans"].items()}}))


if __name__ == "__main__":
    # run as ``-m``, this file is ``__main__``; the program records its
    # spans into the module it imports, so read them there
    from vaeunet_tpu_torch.utils import profiling

    profiling.main()
