"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the roofline bound: the least time the chip could take
for a number of operations and bytes, max(ops / peak, bytes / bandwidth)."""

from __future__ import annotations

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    return max(ops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
