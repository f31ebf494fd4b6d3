"""Host milliseconds a training step spends in the backward: the program's
``train.backward`` spans (``training/step.py``, ``loss.backward()``) of the
traced steps, over their count.  Read under the trace's callback a launch."""

from benchmark.harness.program_spans import host_ms


def read(r):
    return host_ms(r, "train", ("train.backward",))
