from vaeunet_tpu_torch.inference.tiled import (
    adaptive_overlap,
    compute_tile_grid,
    tile_weight_masks,
    predict_with_patches,
    predict_tiled_ensemble,
)
from vaeunet_tpu_torch.inference.predict import (
    predict_full_image,
    predict_image,
    segmentation_distribution,
    uncertainty_maps,
)
from vaeunet_tpu_torch.inference.ensemble import expected_area_threshold, fused_probability

__all__ = [
    "adaptive_overlap",
    "compute_tile_grid",
    "tile_weight_masks",
    "predict_with_patches",
    "predict_tiled_ensemble",
    "predict_full_image",
    "predict_image",
    "segmentation_distribution",
    "uncertainty_maps",
    "fused_probability",
    "expected_area_threshold",
]
