"""Generic directory dataset (milesial BasicDataset style).  A copy of
``vaeunet_tpu/data/generic.py``.

The BASELINE scope note (SURVEY.md) includes the upstream milesial
capabilities: a directory of images + a directory of masks related by a
filename suffix (e.g. Carvana ``<id>.jpg`` / ``<id>_mask.gif``), PIL-scaled,
masks binarized.  This covers the plain-UNet predict/train workflows on
non-fundus data — no fundus-circle logic, no lesion subdirectories.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from vaeunet_tpu_torch.data.dataset import load_image, preprocess_pil

log = logging.getLogger(__name__)


class BasicDataset:
    def __init__(self, images_dir: str, masks_dir: str, scale: float = 1.0,
                 mask_suffix: str = "_mask",
                 max_images: Optional[int] = None):
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir)
        self.scale = scale
        self.mask_suffix = mask_suffix
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".gif")
        self.ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.images_dir)
            if f.lower().endswith(exts) and not f.startswith("."))
        if max_images:
            self.ids = self.ids[:max_images]
        if not self.ids:
            raise RuntimeError(f"No input images in {images_dir}")
        log.info("BasicDataset: %d examples", len(self.ids))

    def _mask_path(self, img_id: str) -> Optional[Path]:
        hits = list(self.masks_dir.glob(img_id + self.mask_suffix + ".*"))
        return hits[0] if hits else None

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        img_id = self.ids[idx]
        img_files = list(self.images_dir.glob(img_id + ".*"))
        img = load_image(img_files[0])
        image = preprocess_pil(img, self.scale, is_mask=False)
        image = image.astype(np.float32) / 255.0
        mask_file = self._mask_path(img_id)
        if mask_file is not None:
            mask = preprocess_pil(Image.open(mask_file).convert("L"),
                                  self.scale, is_mask=True)
        else:
            mask = np.zeros(image.shape[:2], np.float32)
        return {"image": image, "mask": mask[..., None], "img_id": img_id}

    def unique_image_ids(self) -> List[str]:
        return list(self.ids)

    def get_image_and_mask(self, img_id: str):
        s = self[self.ids.index(img_id)]
        return s["image"], s["mask"]
