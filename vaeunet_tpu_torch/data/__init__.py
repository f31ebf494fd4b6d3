"""The IDRiD data pipeline.  Port of ``vaeunet_tpu/data``: the host side
(``fundus``, ``dataset``, ``generic``, ``loader``) is a copy of the JAX
package's numpy code; ``device_cache`` and ``augment`` run in torch on the
device."""

from vaeunet_tpu_torch.data.dataset import IDRIDDataset, LESION_TYPES
from vaeunet_tpu_torch.data.device_cache import (
    DeviceCache,
    ImageDeviceCache,
    estimate_bytes,
    estimate_image_bytes,
)
from vaeunet_tpu_torch.data.generic import BasicDataset
from vaeunet_tpu_torch.data.loader import Loader

__all__ = [
    "IDRIDDataset",
    "LESION_TYPES",
    "BasicDataset",
    "Loader",
    "DeviceCache",
    "ImageDeviceCache",
    "estimate_bytes",
    "estimate_image_bytes",
]
