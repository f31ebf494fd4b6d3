"""Host milliseconds a request spends in the serving entry, outside the
network: the self time of the program's entry-layer spans
(``serve.distribution``, ``serve.tiled``, ``serve.tiles``, ``serve.weights``,
``serve.blend``, ``serve.maps``; ``inference/predict.py``,
``inference/tiled.py``) over the traced requests.  Read under the trace's
callback a launch."""

from benchmark.harness.program_spans import self_host_ms

KIND = "predict"
ENTRY = ("serve.distribution", "serve.tiled", "serve.tiles", "serve.weights", "serve.blend",
         "serve.maps")


def read(r):
    return self_host_ms(r, KIND, ENTRY)
