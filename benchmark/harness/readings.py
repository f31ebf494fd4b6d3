"""What a run hands the per-layer metrics' readers."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import Tracer


@dataclass
class Readings:
    kind: str                            # the traffic's kind: train, uq, predict
    precision: str                       # the precision the path computes in
    items: int = 0                       # steps or requests of the measured window
    work_s: float = 0.0                  # the seconds its end-to-end metric divides by
    flops_per_item: float = 0.0          # the reference's FLOPs of one step or request
    tracer: Optional[Tracer] = None      # the traced segment, after the window
    traced_items: int = 0
    counters: Dict[str, int] = field(default_factory=dict)   # program launch counts, traced
    enqueue_s: List[float] = field(default_factory=list)     # host seconds a call, idle device
    conv3x3_sites: List[Tuple[int, int, int, int, int]] = field(default_factory=list)
