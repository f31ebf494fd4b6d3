"""The fused 3x3 conv + BN statistics kernels' share of their roofline in a
training step (``csrc/conv_bn_stats.cu``).

The bound of every forward 3x3 site of the step, max(operations / 989
TFLOP/s, bytes / 3.35 TB/s) in bf16 (each input, weight and output byte
once), summed over the traced steps, over the device time of the kernels
named below.  Read only when the program's launch counters show one launch
of the kernel a site in every traced step, so that a change of routing
cannot count a site the kernels did not compute."""

from benchmark.harness.flops import conv3x3_bound_s

KERNELS = ("conv3x3_stats_wgmma_kernel", "conv3x3_stats_ci8_kernel", "reduce_partials_kernel")
COUNTERS = ("conv_bn_stats", "conv_bn_stats_ci8")


def read(r):
    if r.kind != "train" or r.tracer is None or not r.traced_items or not r.conv3x3_sites:
        return None
    launches = sum(r.counters.get(c, 0) for c in COUNTERS)
    if launches != len(r.conv3x3_sites) * r.traced_items:
        return None
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items()
                   if any(k in n for k in KERNELS))
    if device_s <= 0:
        return None
    bound = conv3x3_bound_s(r.conv3x3_sites, r.precision) * r.traced_items
    return 100.0 * bound / device_s
