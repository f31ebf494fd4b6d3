"""The share of the traced segment's device-idle time that the entry layer
holds: each idle instant (outside the union of the device intervals) goes
to the innermost program span open then, and the entry layer's are all but
``train.forward``, ``train.backward``, ``serve.latent``, ``serve.encode`` and
``serve.decode`` (``benchmark/harness/program_spans.py``)."""

from benchmark.harness.program_spans import entry_idle_pct

KIND = "train"


def read(r):
    return entry_idle_pct(r, KIND)
