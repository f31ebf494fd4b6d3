"""Training-mode BatchNorms a step that run on torch's ops rather than the
``bn_train`` kernels: the program's ``bn_torch`` counter (``ops/_ext.py``,
counted while the profiler runs) over the traced steps.  The 1x1 and
strided encoder sites, the latent and the attention gates' BNs: 57 a
resnet50 step, 24 a resnet34 one, 12 a UNet one.  A program without the
counter reads nothing."""


def read(r):
    if r.kind != "train" or not r.traced_items or "bn_torch" not in r.counters:
        return None
    return r.counters["bn_torch"] / r.traced_items
