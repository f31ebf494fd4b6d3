"""IDRiD dataset: decode, scale, fundus-crop / patch extraction, caching.
A copy of ``vaeunet_tpu/data/dataset.py``; its default cache home is
``~/.cache/vaeunet_tpu_torch/`` (the JAX package's is
``~/.cache/vaeunet_tpu/``), so the two packages never read each other's
cache files, and ``gather_batch`` goes through the port's ``native``.

Rebuild of reference ``utils/data_loading.py`` (IDRIDDataset) with the same
observable behavior and two deliberate fixes:

- **Deterministic, reusable cache.** The reference deletes and rebuilds its
  patch cache on every construction (data_loading.py:96-100, SURVEY.md
  section 2.4-7).  Here each image's preprocessed arrays are written once to
  ``<base>/patches_tpu/<key>/`` keyed by the preprocessing config, and
  patches are *views* into them (the reference writes every 50%-overlap
  patch to disk separately — 2-4x redundant IO).
- **uint8 storage.** PIL resize returns uint8; the /255 float conversion
  (data_loading.py:599) happens at batch-assembly time, so the cache is 4x
  smaller with bit-identical results.  (Full-image mode caches float32, as
  its torch-style resize produces fractional values — data_loading.py:515-529.)

Behavior kept for parity:
- preprocess: BICUBIC (image) / NEAREST (mask) PIL resize, mask binarized
  >0  (data_loading.py:580-601)
- full-image mode: 95th-percentile fundus diameter x scale as the square
  size (data_loading.py:209-214), fundus-centered square crop with edge
  clamping, bilinear(align_corners=False)/nearest resize
- patch mode: stride = patch_size//2, black-border filter (threshold 0.1,
  0.5 for test; mean-channel < 0.1 counts as black), train-split pos/neg
  balancing to equal counts (data_loading.py:287-300,370-397,415-432)
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from vaeunet_tpu_torch.data.fundus import crop_square_bounds, detect_fundus

log = logging.getLogger(__name__)


def load_image(filename) -> Image.Image:
    """Force RGB (reference data_loading.py:18-28)."""
    img = Image.open(filename)
    return img.convert("RGB")


def preprocess_pil(pil_img: Image.Image, scale: float, is_mask: bool) -> np.ndarray:
    """Resize + convert, matching data_loading.py:580-601.
    Returns HWC uint8 for images, HW float32 {0,1} for masks."""
    w, h = pil_img.size
    new_w, new_h = int(scale * w), int(scale * h)
    if new_w < 1 or new_h < 1:
        raise ValueError(f"Image scaled too small => {new_w}x{new_h}")
    pil_img = pil_img.resize((new_w, new_h),
                             resample=Image.NEAREST if is_mask else Image.BICUBIC)
    arr = np.array(pil_img)
    if is_mask:
        if arr.ndim == 3:
            arr = arr[..., 0]
        return (arr > 0).astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr  # HWC uint8; /255 deferred to batch assembly


def _resize_bilinear_np(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """align_corners=False bilinear on HWC float (crop_to_fundus resize,
    data_loading.py:518-523)."""
    ih, iw = x.shape[:2]
    oh, ow = out_hw

    def coords(i, o):
        c = (np.arange(o, dtype=np.float32) + 0.5) * (i / o) - 0.5
        return np.maximum(c, 0.0)

    cw = coords(iw, ow)
    i0 = np.clip(np.floor(cw).astype(np.int64), 0, iw - 1)
    i1 = np.minimum(i0 + 1, iw - 1)
    lw = (cw - i0).astype(np.float32)[None, :, None]
    x = x[:, i0] * (1 - lw) + x[:, i1] * lw
    ch = coords(ih, oh)
    j0 = np.clip(np.floor(ch).astype(np.int64), 0, ih - 1)
    j1 = np.minimum(j0 + 1, ih - 1)
    lh = (ch - j0).astype(np.float32)[:, None, None]
    return x[j0] * (1 - lh) + x[j1] * lh


def _resize_nearest_np(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    ih, iw = x.shape[:2]
    oh, ow = out_hw
    ii = np.floor(np.arange(oh) * (ih / oh)).astype(np.int64).clip(0, ih - 1)
    jj = np.floor(np.arange(ow) * (iw / ow)).astype(np.int64).clip(0, iw - 1)
    return x[ii][:, jj]


LESION_TYPES = ("EX", "HE", "MA", "SE", "OD")


class IDRIDDataset:
    """Loads fundus JPGs + per-lesion TIF masks and serves patch samples.

    Samples are dicts {'image': HWC float32 in [0,1], 'mask': HW1 float32,
    'img_id': str} — the NHWC analogue of the reference's CHW samples
    (data_loading.py:603-633).

    ``lesion_type="ALL"`` (framework extension; the reference loads exactly
    one lesion family per run, data_loading.py:42-47) serves a 5-channel
    mask ordered by :data:`LESION_TYPES` for multi-task training — a
    missing per-lesion TIF means the image has none of that lesion in
    IDRiD, so absent channels are true all-zero negatives, not missing
    labels.  Sample masks are then HW5.
    """

    def __init__(self, base_dir: str, split: str = "train", scale: float = 0.25,
                 patch_size: Optional[int] = None, lesion_type: str = "EX",
                 max_images: Optional[int] = None,
                 skip_border_check: bool = False,
                 cache_dir: Optional[str] = None,
                 balance_seed: Optional[int] = None,
                 oversample_lesion: float = 0.0):
        self.base_dir = Path(base_dir)
        self.split = split
        self.scale = scale
        self.lesion_type = lesion_type
        self.skip_border_check = skip_border_check
        self.is_full_image = patch_size is None
        self.balance_seed = balance_seed
        self.oversample_lesion = oversample_lesion

        self.images_dir = self.base_dir / "imgs" / split
        self.masks_dir = self.base_dir / "masks" / split

        ids = sorted(
            f[:-4] for f in os.listdir(self.images_dir) if f.endswith(".jpg"))
        if max_images is not None:
            ids = ids[:max_images]
        self.mask_channels = (LESION_TYPES if lesion_type == "ALL"
                              else (lesion_type,))
        self.ids = [
            i for i in ids
            if any((self.masks_dir / lt / f"{i}_{lt}.tif").exists()
                   for lt in self.mask_channels)
        ]
        if not self.ids:
            raise RuntimeError(
                f"No valid image-mask pairs in {self.images_dir} / {self.masks_dir}")
        log.info("Found %d valid image-mask pairs", len(self.ids))

        if self.is_full_image:
            self.patch_size = self._find_full_image_size()
        else:
            self.patch_size = patch_size
        self.stride = self.patch_size // 2 if not self.is_full_image else self.patch_size

        # Default cache home is OUTSIDE the dataset dir (which may be a
        # read-only mount): $VAEUNET_CACHE_DIR > ~/.cache/vaeunet_tpu_torch/<id>,
        # where <id> keys the absolute data path.  The reference rebuilds
        # its patch cache inside the data dir on every run
        # (data_loading.py:96-100); here the cache is deterministic,
        # config-keyed, and relocatable.
        if cache_dir:
            cache_root = Path(cache_dir)
        elif os.environ.get("VAEUNET_CACHE_DIR"):
            cache_root = Path(os.environ["VAEUNET_CACHE_DIR"])
        else:
            data_id = hashlib.sha1(
                str(self.base_dir.absolute()).encode()).hexdigest()[:10]
            cache_root = (Path.home() / ".cache" / "vaeunet_tpu_torch"
                          / f"patches_{data_id}")
        self.cache_dir = cache_root / self._cache_key()
        self._build_or_load_cache()
        self._build_index()

    # -- cache -------------------------------------------------------------

    def _cache_key(self) -> str:
        spec = dict(split=self.split, scale=self.scale,
                    patch=self.patch_size if self.is_full_image else "raw",
                    full=self.is_full_image, lesion=self.lesion_type,
                    ids=self.ids, v=2)
        h = hashlib.sha1(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:12]
        mode = f"full{self.patch_size}" if self.is_full_image else "scaled"
        return f"{self.split}_{self.lesion_type}_{mode}_{h}"

    def _find_full_image_size(self) -> int:
        """95th-percentile fundus diameter x scale (data_loading.py:182-221)."""
        diameters = []
        for img_id in self.ids:
            try:
                with Image.open(self.images_dir / f"{img_id}.jpg") as img:
                    d, _ = detect_fundus(np.array(img))
                if d is not None:
                    diameters.append(float(d))
            except Exception as e:
                log.warning("Couldn't process %s: %s", img_id, e)
        if diameters:
            size = int(np.percentile(diameters, 95) * self.scale)
            log.info("Typical fundus diameter (95th pct): %d", size)
            return size
        log.warning("No fundus diameters detected, using fallback size 694")
        return 694

    def _build_or_load_cache(self):
        meta_path = self.cache_dir / "meta.json"
        if meta_path.exists():
            self.meta = json.loads(meta_path.read_text())
            return
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        meta: Dict[str, Dict] = {}
        for img_id in self.ids:
            img = load_image(self.images_dir / f"{img_id}.jpg")
            img_arr = preprocess_pil(img, self.scale, is_mask=False)   # HWC u8
            channels, bad = [], False
            for lt in self.mask_channels:
                mask_path = self.masks_dir / lt / f"{img_id}_{lt}.tif"
                if not mask_path.exists():
                    channels.append(np.zeros(img_arr.shape[:2], np.float32))
                    continue
                mask = Image.open(mask_path).convert("L")
                if img.size != mask.size:
                    log.warning("Size mismatch for %s (%s); skipping",
                                img_id, lt)
                    bad = True
                    break
                channels.append(preprocess_pil(mask, self.scale,
                                               is_mask=True))  # HW f32
            if bad:
                continue
            mask_arr = (channels[0] if len(channels) == 1
                        else np.stack(channels, axis=-1))       # HW or HWC

            if self.is_full_image:
                d, center = detect_fundus(img_arr)
                h, w = img_arr.shape[:2]
                if d is None:
                    d, center = float(min(h, w)), (w // 2, h // 2)
                t, b, l, r = crop_square_bounds(h, w, center, d)
                ci = img_arr[t:b, l:r].astype(np.float32) / 255.0
                cm = mask_arr[t:b, l:r]
                if ci.shape[0] != self.patch_size:
                    ci = _resize_bilinear_np(ci, (self.patch_size, self.patch_size))
                    cm = _resize_nearest_np(cm, (self.patch_size, self.patch_size))
                np.savez(self.cache_dir / f"{img_id}.npz",
                         image_f32=ci.astype(np.float32),
                         mask=(cm > 0.5).astype(np.uint8))
                meta[img_id] = {"h": int(ci.shape[0]), "w": int(ci.shape[1]),
                                "full": True,
                                "has_lesion": bool((mask_arr > 0.5).any())}
            else:
                np.savez(self.cache_dir / f"{img_id}.npz",
                         image_u8=img_arr,
                         mask=(mask_arr > 0.5).astype(np.uint8))
                meta[img_id] = {"h": int(img_arr.shape[0]),
                                "w": int(img_arr.shape[1]), "full": False}
        self.meta = meta
        meta_path.write_text(json.dumps(meta))

    # -- patch index ---------------------------------------------------------

    def _image_arrays(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (image HWC float32 in [0,1], mask HW float32 {0,1})."""
        z = np.load(self.cache_dir / f"{img_id}.npz")
        if "image_f32" in z:
            return z["image_f32"], z["mask"].astype(np.float32)
        return z["image_u8"].astype(np.float32) / 255.0, z["mask"].astype(np.float32)

    def _image_arrays_u8(self, img_id: str):
        """(image HWC uint8, mask HW uint8) without float conversion, or
        None in full-image/float-cache mode — the DeviceCache bulk-assembly
        path."""
        z = np.load(self.cache_dir / f"{img_id}.npz")
        if "image_u8" not in z:
            return None
        return z["image_u8"], z["mask"]

    def _build_index(self):
        """Enumerate (img_id, y, x, has_lesion) patch records with border
        filtering and train-split balancing (data_loading.py:302-446)."""
        self._cache_arrays: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        positives: List[Tuple[str, int, int]] = []
        negatives: List[Tuple[str, int, int]] = []
        records: List[Tuple[str, int, int, bool]] = []

        threshold = 0.5 if self.split == "test" else 0.1

        # The enumeration sweep (border checks + lesion tests over every
        # patch of every image) costs minutes at scale 1.0; its result is a
        # pure function of the cached pixels + these knobs, so persist it.
        index_path = self.cache_dir / (
            f"index_p{self.patch_size}_b{int(not self.skip_border_check)}"
            f"_t{threshold}.json")
        if index_path.exists():
            cached = json.loads(index_path.read_text())
            positives = [tuple(r) for r in cached["positives"]]
            negatives = [tuple(r) for r in cached["negatives"]]
            self._finalize_index(positives, negatives, records)
            return

        for img_id, m in self.meta.items():
            if self.is_full_image:
                records.append((img_id, 0, 0, bool(m.get("has_lesion", False))))
                continue
            h, w = m["h"], m["w"]
            if h < self.patch_size or w < self.patch_size:
                log.warning("%s: %dx%d < patch_size=%d; skipping",
                            img_id, h, w, self.patch_size)
                continue
            img, mask = self._image_arrays(img_id)
            stride = self.patch_size // 2
            for y in range(0, h - self.patch_size + 1, stride):
                for x in range(0, w - self.patch_size + 1, stride):
                    ip = img[y:y + self.patch_size, x:x + self.patch_size]
                    if not self.skip_border_check:
                        black = (ip.mean(axis=-1) < 0.1).mean()
                        if black > threshold:
                            continue
                    mp = mask[y:y + self.patch_size, x:x + self.patch_size]
                    hit = mp > 0.5
                    if hit.ndim == 3:     # multi-lesion: any channel counts
                        hit = hit.any(axis=-1)
                    frac = float(hit.mean())
                    if frac > 0.0:
                        positives.append((img_id, y, x, frac))
                    else:
                        negatives.append((img_id, y, x))

        if not self.is_full_image:
            try:
                index_path.write_text(json.dumps(
                    {"positives": positives, "negatives": negatives}))
            except OSError as e:  # read-only cache is non-fatal
                log.warning("Couldn't persist patch index: %s", e)
        self._finalize_index(positives, negatives, records)

    def _finalize_index(self, positives, negatives, records):
        """Balance + oversample the enumerated patches into patch_index."""
        if not self.is_full_image:
            if self.split == "train":
                rng = random.Random(self.balance_seed)
                rng.shuffle(negatives)
                negatives = negatives[:len(positives)]
            pos_records = []
            for i, y, x, frac in positives:
                # Large confluent lesions live in few patches; the reference's
                # pretrained encoder copes, a from-scratch one underfits that
                # mode.  oversample_lesion>0 (train split) replicates a patch
                # 1 + min(4, floor(frac * oversample_lesion)) times so plaque
                # interiors keep gradient share.  0 = reference-parity
                # balancing (data_loading.py:302-446).
                reps = 1
                if self.oversample_lesion > 0 and self.split == "train":
                    reps += min(4, int(frac * self.oversample_lesion))
                pos_records.extend([(i, y, x, True)] * reps)
            records = (pos_records
                       + [(i, y, x, False) for i, y, x in negatives])
            if self.split == "test" and not records:
                records = [(i, y, x, False) for i, y, x in negatives[:10]]
        self.patch_index = records
        log.info("%s/%s: %d patches (%d positive)", self.split, self.lesion_type,
                 len(records), sum(1 for r in records if r[3]))

    # -- access ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.patch_index)

    def __getitem__(self, idx: int) -> Dict:
        img_id, y, x, has_lesion = self.patch_index[idx]
        if img_id not in self._cache_arrays:
            if len(self._cache_arrays) > 16:  # bounded host RAM
                self._cache_arrays.clear()
            self._cache_arrays[img_id] = self._image_arrays(img_id)
        img, mask = self._cache_arrays[img_id]
        if not self.is_full_image:
            img = img[y:y + self.patch_size, x:x + self.patch_size]
            mask = mask[y:y + self.patch_size, x:x + self.patch_size]
        if mask.ndim == 2:
            mask = mask[..., None]
        return {"image": np.ascontiguousarray(img),
                "mask": np.ascontiguousarray(mask),
                "img_id": img_id, "coords": (y, x),
                "has_lesion": has_lesion}

    def gather_batch(self, indices) -> Optional[Dict]:
        """Native-thread batch assembly (patch mode, uint8 cache): gathers
        all patches of a batch in one C++ call (vaeunet_tpu_torch.native), the
        DataLoader-worker equivalent.  Returns None when unavailable
        (full-image mode / float cache) — callers fall back to __getitem__.
        """
        if self.is_full_image or len(self.mask_channels) > 1:
            # the C++ gather handles single-plane HW masks only
            return None
        from vaeunet_tpu_torch import native
        records = [self.patch_index[int(i)] for i in indices]
        planes_i, planes_m, coords, ids = [], [], [], []
        for img_id, y, x, _ in records:
            if img_id not in self._raw_cache():
                z = np.load(self.cache_dir / f"{img_id}.npz")
                if "image_u8" not in z:
                    return None
                self._raw[img_id] = (np.ascontiguousarray(z["image_u8"]),
                                     np.ascontiguousarray(z["mask"]))
            img, mask = self._raw[img_id]
            planes_i.append(img)
            planes_m.append(mask)
            coords.append((y, x))
            ids.append(img_id)
        images, masks = native.gather_patch_batch(
            planes_i, planes_m, np.asarray(coords, np.int32), self.patch_size)
        return {"image": images, "mask": masks, "img_id": ids}

    def _raw_cache(self):
        if not hasattr(self, "_raw"):
            self._raw: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if len(self._raw) > 32:
            self._raw.clear()
        return self._raw

    def unique_image_ids(self) -> List[str]:
        seen = []
        for img_id, *_ in self.patch_index:
            if img_id not in seen:
                seen.append(img_id)
        return seen

    def get_image_and_mask(self, img_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """Full preprocessed image + mask for an id (the analysis CLIs'
        stitching source, visualize_vae.py:479-575 — here the unpatched
        arrays are cached, so no feathered re-stitching is needed)."""
        img, mask = self._image_arrays(img_id)
        return img, (mask[..., None] if mask.ndim == 2 else mask)
