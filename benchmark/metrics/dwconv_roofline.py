"""The depthwise convolutions' share of their roofline in a training step
(``ops/layers.py::DepthwiseConv``, on cuDNN's grouped convolutions).

The byte bound of the depthwise convs the program's ``dwconv`` counter saw
in the traced steps, 3 x ``dwconv_bytes`` / 3.35 TB/s: ``dwconv_bytes`` is
each forward's input and output bytes, and the forward, the data gradient
and the weight gradient each read and write an input-sized and an
output-sized tensor (their FLOPs, at most 25 multiply-adds an element read,
stay under 1 % of that bound).  Over the device time of the kernels whose
names hold one of ``KERNELS``: the ones a depthwise conv's forward and
backward launch on the H100, and none of a dense 3x3 conv's (a card test
pins both, ``tests/test_torch_cuda_bn_train.py``).  Read only where the
counter saw a depthwise conv and those kernels took time; a program without
the counter reads nothing."""

from benchmark.harness.peaks import HBM_BYTES_PER_S

KERNELS = ("2d_c1_k1_nhwc", "grouped_direct")
PASSES = 3


def read(r):
    if r.kind != "train" or r.tracer is None or not r.counters.get("dwconv"):
        return None
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items()
                   if any(k in n for k in KERNELS))
    if device_s <= 0:
        return None
    return 100.0 * PASSES * r.counters.get("dwconv_bytes", 0) / HBM_BYTES_PER_S / device_s
