"""The optimizer step's kernels: their share of their roofline in a
training step (``csrc/clip_adamw.cu``, clip by global norm then AdamW).

The byte bound of the elements the update launches stepped in the traced
steps (the program's ``clip_adamw_elems``), 32 bytes an element (g read by
the norm and again by the update; p, exp_avg and exp_avg_sq read and
written) / 3.35 TB/s, over the device time of the kernels whose names start
``clip_adamw_``.  Read only when the program's counters show one norm and
one update launch in every traced step; a program without those counters
reads nothing.  A step that clips also writes g back, 4 bytes more an
element that the bound leaves out: the share then reads low, never high."""

from benchmark.harness.peaks import HBM_BYTES_PER_S

KERNEL = "clip_adamw_"
COUNTERS = ("clip_adamw_norm", "clip_adamw_update")
BYTES_PER_ELEMENT = 32


def read(r):
    if r.kind != "train" or r.tracer is None or not r.traced_items:
        return None
    if any(r.counters.get(c) != r.traced_items for c in COUNTERS):
        return None
    elems = r.counters.get("clip_adamw_elems", 0)
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items() if KERNEL in n)
    if elems <= 0 or device_s <= 0:
        return None
    return 100.0 * BYTES_PER_ELEMENT * elems / HBM_BYTES_PER_S / device_s
