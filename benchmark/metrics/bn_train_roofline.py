"""The training BN + ReLU kernels' share of their roofline in a training
step (``csrc/bn_train.cu``).

The byte bound of every 3x3 conv + BN site of the step, (5 x N H W Co x the
element size + 32 Co) / 3.35 TB/s (y in and out out forward, g and y in and
dy out backward, and the site's fp32 [Co] vectors), summed over the traced
steps, over the device time of the kernels whose names start ``bn_train_``.
Read only when the program's launch counters show one forward launch and
one backward call a site in every traced step; a program without those
counters reads nothing."""

from benchmark.harness.flops import BYTES
from benchmark.harness.peaks import HBM_BYTES_PER_S

KERNEL = "bn_train_"
COUNTERS = ("bn_train_fwd", "bn_train_bwd")


def read(r):
    if r.kind != "train" or r.tracer is None or not r.traced_items or not r.conv3x3_sites:
        return None
    want = len(r.conv3x3_sites) * r.traced_items
    if any(r.counters.get(c) != want for c in COUNTERS):
        return None
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items() if KERNEL in n)
    if device_s <= 0:
        return None
    e = BYTES[r.precision]
    nbytes = sum(5 * n * h * w * co * e + 32 * co for n, _, h, w, co in r.conv3x3_sites)
    return 100.0 * nbytes / HBM_BYTES_PER_S * r.traced_items / device_s
