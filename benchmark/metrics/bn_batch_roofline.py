"""The training BatchNorms over their own batch moments (the ``bn_batch_``
kernels of ``csrc/bn_train.cu``): their share of their roofline in a
training step.

The byte bound of the BNs the program's ``bn_batch_fwd`` counter saw in the
traced steps, 5 x ``bn_batch_bytes`` / 3.35 TB/s (x in and y out forward,
g and x in and dx out backward: the yardstick of ``bn_torch_roofline`` and
``bn_train_roofline``, whatever implements the BN), over the device time of
the kernels whose names contain ``bn_batch_`` (the moments pass, the
normalisation and the backward's two passes).  Read only where the counter
saw a BN and those kernels took time; a program without the counter reads
nothing.

As for ``bn_torch_roofline``, the share holds for a one-process step
without remat, as every training cell runs: a remat recompute counts its
BN a second time at five passes for one more forward, and would read
high."""

from benchmark.harness.peaks import HBM_BYTES_PER_S

KERNEL = "bn_batch_"
PASSES = 5


def read(r):
    if r.kind != "train" or r.tracer is None or not r.counters.get("bn_batch_fwd"):
        return None
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items() if KERNEL in n)
    if device_s <= 0:
        return None
    return 100.0 * PASSES * r.counters.get("bn_batch_bytes", 0) / HBM_BYTES_PER_S / device_s
