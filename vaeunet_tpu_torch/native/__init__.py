"""ctypes bindings for the native host-side data engine (``host_ops.cpp``).
A copy of ``vaeunet_tpu/native/__init__.py``, built elsewhere.

The library is built at first use by g++ (plain C ABI + ctypes; the flags
of the ``Makefile`` beside the source, which builds the same library by
hand) into ``build/native/`` at the root of the checkout, named by a hash
of the source and the flags, so a checkout builds it once and never writes
into the package directory.  Every entry point keeps its pure-numpy fallback,
which is also the plain version the tests hold the library against;
:func:`available` says which one runs and :func:`require` raises with the
build's error where the fallback must not stand in.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = Path(__file__).parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread")    # the Makefile's
_lib = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    key = hashlib.sha1((_DIR / "host_ops.cpp").read_bytes()
                       + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libvaeunet_host-{key}.so"


def _build(path: Path) -> None:
    """g++ into a private name, then an atomic rename: processes that
    build at once never load a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", str(tmp),
                        str(_DIR / "host_ops.cpp")], check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.gather_patch_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.gather_patch_batch_u8.restype = None
        lib.feathered_blend_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64]
        lib.feathered_blend_f32.restype = None
        lib.resize_bilinear_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.resize_bilinear_f32.restype = None
        _lib = lib
        log.info("native host ops loaded from %s", path)
    except (OSError, subprocess.CalledProcessError) as e:  # no compiler / build failure
        detail = getattr(e, "stderr", None) or ""
        _error = f"{e} {detail}".strip()
        log.warning("native host ops unavailable (%s); using numpy fallback", _error)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def require() -> None:
    """Raise unless the native library is built and loaded."""
    if _load() is None:
        raise RuntimeError(f"native host ops unavailable: {_error}")


def gather_patch_batch(images: Sequence[np.ndarray],
                       masks: Sequence[np.ndarray],
                       coords: np.ndarray, patch: int,
                       num_threads: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Per-patch gather: images[b] is an HWC uint8 plane, masks[b] an HW
    uint8 plane, coords [B,2] int32 (y,x) -> (float32 [B,P,P,3] in [0,1],
    float32 [B,P,P,1])."""
    lib = _load()
    b = len(images)
    coords = np.ascontiguousarray(coords, np.int32)
    out_img = np.empty((b, patch, patch, 3), np.float32)
    out_msk = np.empty((b, patch, patch), np.float32)
    if lib is None:
        for i in range(b):
            y, x = int(coords[i, 0]), int(coords[i, 1])
            out_img[i] = images[i][y:y + patch, x:x + patch].astype(np.float32) / 255.0
            out_msk[i] = (masks[i][y:y + patch, x:x + patch] > 0).astype(np.float32)
        return out_img, out_msk[..., None]

    for im, m in zip(images, masks):
        if (im.dtype != np.uint8 or m.dtype != np.uint8 or im.ndim != 3 or m.ndim != 2
                or im.shape[2] != 3 or im.strides[1:] != (3, 1) or m.strides[1] != 1):
            raise ValueError("gather_patch_batch: planes must be uint8 HWC (C = 3) and HW "
                             "with contiguous rows")
    if coords.shape != (b, 2) or (coords < 0).any() or any(
            y + patch > im.shape[0] or x + patch > im.shape[1]
            for (y, x), im in zip(coords.tolist(), images)):
        raise ValueError("gather_patch_batch: a patch lies outside its image")
    img_ptrs = (ctypes.c_void_p * b)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in images])
    msk_ptrs = (ctypes.c_void_p * b)(
        *[m.ctypes.data_as(ctypes.c_void_p).value for m in masks])
    img_strides = np.asarray([im.strides[0] for im in images], np.int64)
    msk_strides = np.asarray([m.strides[0] for m in masks], np.int64)
    lib.gather_patch_batch_u8(
        img_ptrs, msk_ptrs,
        coords.ctypes.data_as(ctypes.c_void_p), b, patch,
        img_strides.ctypes.data_as(ctypes.c_void_p),
        msk_strides.ctypes.data_as(ctypes.c_void_p),
        out_img.ctypes.data_as(ctypes.c_void_p),
        out_msk.ctypes.data_as(ctypes.c_void_p), num_threads)
    return out_img, out_msk[..., None]


def feathered_blend(tiles: np.ndarray, weights: np.ndarray,
                    coords: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[T,P,P] tiles + weights scatter-blended into [H,W] (normalized)."""
    lib = _load()
    h, w = out_hw
    tiles = np.ascontiguousarray(tiles, np.float32)
    weights = np.ascontiguousarray(
        np.broadcast_to(weights, tiles.shape), np.float32)
    coords = np.ascontiguousarray(coords, np.int32)
    out = np.zeros((h, w), np.float32)
    wsum = np.zeros((h, w), np.float32)
    if lib is None:
        p = tiles.shape[1]
        for t in range(tiles.shape[0]):
            y, x = int(coords[t, 0]), int(coords[t, 1])
            out[y:y + p, x:x + p] += tiles[t] * weights[t]
            wsum[y:y + p, x:x + p] += weights[t]
    else:
        p = tiles.shape[1]
        if (coords < 0).any() or any(y + p > h or x + p > w for y, x in coords.tolist()):
            raise ValueError("feathered_blend: a tile lies outside the output")
        lib.feathered_blend_f32(
            tiles.ctypes.data_as(ctypes.c_void_p),
            weights.ctypes.data_as(ctypes.c_void_p),
            coords.ctypes.data_as(ctypes.c_void_p),
            tiles.shape[0], tiles.shape[1],
            out.ctypes.data_as(ctypes.c_void_p),
            wsum.ctypes.data_as(ctypes.c_void_p), h, w)
    return out / (wsum + 1e-8)


def resize_bilinear(image: np.ndarray, out_hw: Tuple[int, int],
                    num_threads: int = 6) -> np.ndarray:
    """align_corners=False bilinear resize of [H,W,C] float32 (torch
    convention, matching dataset._resize_bilinear_np)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    h, w, c = image.shape
    oh, ow = out_hw
    if lib is None:
        from vaeunet_tpu_torch.data.dataset import _resize_bilinear_np
        return _resize_bilinear_np(image, out_hw)
    out = np.empty((oh, ow, c), np.float32)
    lib.resize_bilinear_f32(
        image.ctypes.data_as(ctypes.c_void_p), h, w, c,
        out.ctypes.data_as(ctypes.c_void_p), oh, ow, num_threads)
    return out
