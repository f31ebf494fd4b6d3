"""Host milliseconds to enqueue one training step on an idle device: the
median over the steps run after the traced segment, each started after a
synchronize and timed to the step call's return (training entry,
``training/step.py``, host side)."""

from benchmark.harness.stats import median


def read(r):
    if r.kind != "train" or not r.enqueue_s:
        return None
    return median(r.enqueue_s) * 1e3
