"""Device kernels a training step launches: the kernels of the traced
steps (copies and sets left out) over their count.  The ops and kernel
wrappers (``ops/``, ``ops/pallas/``, ``ops/_ext.py``) plus the library's
calls; a count, which repeats exactly."""


def read(r):
    if r.kind != "train" or r.tracer is None or not r.traced_items:
        return None
    return len(r.tracer.kernels()) / r.traced_items
