"""Host milliseconds a training step spends in its entry, outside the model
and the optimizer: the self time of the program's ``train.step`` span
(``training/step.py``: layouts, the aux results) plus its ``train.gather``
(the batch taken from the device pool by host index), over the traced
steps.  Read under the trace's callback a launch."""

from benchmark.harness.program_spans import self_host_ms


def read(r):
    return self_host_ms(r, "train", ("train.step", "train.gather"))
