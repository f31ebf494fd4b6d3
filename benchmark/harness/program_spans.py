"""The program's own spans in a traced segment, and what the per-layer
metrics take from them.

``vaeunet_tpu_torch/utils/profiling.py`` records spans at the program's
layer boundaries while a ``torch.profiler`` session runs, stamped with
``time.time_ns()``, the clock of the trace's window and device events
(``harness/trace.py``).  Each is (index, name, start_ns, end_ns, parent,
root): parent is the enclosing span's index, -1 for a root.  The arithmetic
lives here, in the benchmark, so the yardstick does not move with the code
it measures:

- the window's spans: those that overlap the traced window, or none where
  one of them crosses its edge (the clocks disagree), where the program
  records no spans, or where the entry's roots (``ROOTS``) do not number
  the traced items;
- a span's self time: its duration less its children's (one thread's
  spans nest, so children do not overlap);
- idle by span: each idle instant of the window (outside the union of the
  device intervals) goes to the innermost span open at that instant, the
  gaps split at span edges.

Spans of the model step (``MODEL_SPANS``) compute the network; every other
span is the entry layer's (the train step's gather, clip and AdamW; the
request's tiles, weights, blending and maps).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from benchmark.harness.trace import union_intervals

ROOTS = {"train": "train.step", "uq": "serve.distribution", "predict": "serve.tiled"}
MODEL_SPANS = frozenset({"train.forward", "train.backward", "serve.latent", "serve.encode",
                         "serve.decode"})


class Span(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


def _recorded() -> Optional[List[Span]]:
    try:
        from vaeunet_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)     # a program that records none
    return None if read is None else [Span(*s) for s in read()]


def window_spans(r, kind: str) -> Optional[List[Span]]:
    """The program's spans of `r`'s traced segment, for a run of `kind`."""
    if r.kind != kind or r.tracer is None or not r.traced_items:
        return None
    recorded = _recorded()
    if recorded is None:
        return None
    a, b = r.tracer.start_ns, r.tracer.end_ns
    mine = [s for s in recorded if s.end_ns > a and s.start_ns < b]
    if any(s.start_ns < a or s.end_ns > b for s in mine):
        return None
    roots = sum(s.name == ROOTS[kind] and s.parent < 0 for s in mine)
    return mine if roots == r.traced_items else None


def self_ns(spans: List[Span]) -> Dict[int, int]:
    out = {s.index: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def idle_ns(r, spans: List[Span]) -> Tuple[int, Dict[int, int]]:
    """-> (the window's idle ns, {span index: idle ns it holds as the
    innermost open span})."""
    a, b = r.tracer.start_ns, r.tracer.end_ns
    gaps, t = [], a
    for x, y in union_intervals([(x, y) for _, x, y in r.tracer.inside()]):
        if x > t:
            gaps.append((t, x))
        t = max(t, y)
    if b > t:
        gaps.append((t, b))
    starts = [x for x, _ in gaps]
    before = [0]
    for x, y in gaps:
        before.append(before[-1] + y - x)

    def idle_until(t: int) -> int:
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return 0
        x, y = gaps[k]
        return before[k] + min(t, y) - x

    inside = {s.index: idle_until(s.end_ns) - idle_until(s.start_ns) for s in spans}
    held = dict(inside)
    for s in spans:
        if s.parent in held:
            held[s.parent] -= inside[s.index]
    return before[-1], held


def _ms_an_item(r, kind: str, names: Iterable[str], own: bool) -> Optional[float]:
    spans = window_spans(r, kind)
    if spans is None:
        return None
    names = set(names)
    ns = self_ns(spans) if own else {s.index: s.end_ns - s.start_ns for s in spans}
    return sum(ns[s.index] for s in spans if s.name in names) / r.traced_items * 1e-6


def host_ms(r, kind: str, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds an item inside the spans named, or None where the
    segment has no spans to read."""
    return _ms_an_item(r, kind, names, own=False)


def self_host_ms(r, kind: str, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds an item in the spans named outside their children."""
    return _ms_an_item(r, kind, names, own=True)


def entry_idle_pct(r, kind: str) -> Optional[float]:
    """The share of the window's device-idle time that an entry-layer span
    holds as the innermost span."""
    spans = window_spans(r, kind)
    if spans is None:
        return None
    total, held = idle_ns(r, spans)
    if total <= 0:
        return None
    return 100.0 * sum(held[s.index] for s in spans if s.name not in MODEL_SPANS) / total
