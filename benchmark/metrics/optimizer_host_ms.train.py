"""Host milliseconds a training step spends in the optimizer: the program's
``train.clip`` and ``train.adamw`` spans (``training/state.py``,
``ClippedAdamW.step``) of the traced steps, over their count.  Read under
the trace's callback a launch."""

from benchmark.harness.program_spans import host_ms


def read(r):
    return host_ms(r, "train", ("train.clip", "train.adamw"))
