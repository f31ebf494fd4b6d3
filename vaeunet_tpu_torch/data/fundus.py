"""Circular fundus-region detection (host-side, runs once per image).  A copy
of ``vaeunet_tpu/data/fundus.py``.

Rebuild of reference ``utils/data_loading.py:223-285``: grayscale -> median
blur -> threshold(10) -> largest external contour -> min enclosing circle.
cv2 when available, with a pure-numpy fallback (connected components via
flood-free row scanning is unnecessary — the fundus is the only bright blob,
so a threshold bounding-box circle matches in practice).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def detect_fundus(image: np.ndarray) -> Tuple[Optional[float], Tuple[Optional[int], Optional[int]]]:
    """-> (diameter, (center_x, center_y)); (None, (None, None)) on failure."""
    try:
        if image.ndim == 3:
            if _HAS_CV2:
                gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
            else:
                gray = image.mean(axis=-1)
        else:
            gray = image
        if gray.dtype != np.uint8:
            if gray.dtype in (np.float32, np.float64):
                gray = (gray * 255).astype(np.uint8)
            else:
                gray = gray.astype(np.uint8)

        if _HAS_CV2:
            gray = cv2.medianBlur(gray, 5)
            _, thresh = cv2.threshold(gray, 10, 255, cv2.THRESH_BINARY)
            contours, _ = cv2.findContours(thresh.astype(np.uint8),
                                           cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            if contours:
                largest = max(contours, key=cv2.contourArea)
                (x, y), radius = cv2.minEnclosingCircle(largest)
                m = cv2.moments(largest)
                if m["m00"] != 0:
                    cx, cy = int(m["m10"] / m["m00"]), int(m["m01"] / m["m00"])
                else:
                    cx, cy = int(x), int(y)
                return float(radius * 2), (cx, cy)
        else:
            mask = gray > 10
            if mask.any():
                ys, xs = np.nonzero(mask)
                cy, cx = int(ys.mean()), int(xs.mean())
                diameter = float(max(ys.max() - ys.min(), xs.max() - xs.min()) + 1)
                return diameter, (cx, cy)

        h, w = gray.shape[:2]
        return float(min(h, w)), (w // 2, h // 2)
    except Exception as e:  # pragma: no cover
        logging.error(f"detect_fundus failed: {e}")
        return None, (None, None)


def crop_square_bounds(h: int, w: int, center: Tuple[int, int],
                       diameter: float) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of the square crop containing the fundus
    circle, with the reference's edge-clamping and re-squaring rules
    (data_loading.py:469-505)."""
    cx, cy = center
    square = int(np.ceil(diameter))
    half = square // 2
    top = max(0, cy - half)
    bottom = min(h, cy + half + (square % 2))
    left = max(0, cx - half)
    right = min(w, cx + half + (square % 2))
    if top == 0:
        bottom = min(h, square)
    if left == 0:
        right = min(w, square)
    if bottom == h:
        top = max(0, h - square)
    if right == w:
        left = max(0, w - square)
    ah, aw = bottom - top, right - left
    if ah != aw:
        new = min(ah, aw)
        if ah > new:
            diff = ah - new
            top += diff // 2
            bottom = top + new
        else:
            diff = aw - new
            left += diff // 2
            right = left + new
    return top, bottom, left, right
