"""The whole step's or request's share of the chip's peak: the reference's
convolution FLOPs of one step (forward and backward) or one request (every
real tile, and the whole image's encode where the request has one), times
the window's steps or requests, over the seconds the cell's end-to-end
metric divides by, over the peak of the path's precision (bf16 989
TFLOP/s, float32 67 TFLOP/s)."""

from benchmark.harness.peaks import FLOPS

KIND = "predict"


def read(r):
    if r.kind != KIND or not r.items or r.work_s <= 0 or not r.flops_per_item:
        return None
    return 100.0 * r.flops_per_item * r.items / r.work_s / FLOPS[r.precision]
