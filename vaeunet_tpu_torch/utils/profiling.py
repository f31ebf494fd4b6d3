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

The program's spans (:func:`span`) mark its layer boundaries: the train
step's phases (``train.*``: ``training/step.py``, ``training/state.py``)
and the tiled request's stages (``serve.*``: ``inference/predict.py``,
``inference/tiled.py``).  A span is recorded only while a
``torch.profiler`` session runs, in memory, stamped with
``time.time_ns()``, the clock of the profiler's device events; otherwise
entering one costs a read of the profiler's own flag.  :func:`spans`
returns what was recorded as :class:`Span` tuples: every span of one step
or request carries the index of its outermost span as ``root``.  The
benchmark's traced run (``benchmark/run.py --trace 1``) reads them beside
the device trace (``benchmark/harness/program_spans.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator, List, NamedTuple, Optional

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
