"""Host milliseconds a training step spends in the model's forward: the
program's ``train.forward`` spans (``training/step.py``: model, criterion,
KL, once a microbatch) of the traced steps, over their count.  Read under
the trace's callback a launch, as the parent's and the change's runs alike."""

from benchmark.harness.program_spans import host_ms


def read(r):
    return host_ms(r, "train", ("train.forward",))
