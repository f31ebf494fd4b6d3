from vaeunet_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_nearest,
    upsample2x_bilinear_align_corners,
)
from vaeunet_tpu_torch.ops.pool import max_pool, avg_pool_global

__all__ = [
    "resize_bilinear",
    "resize_nearest",
    "upsample2x_bilinear_align_corners",
    "max_pool",
    "avg_pool_global",
]
