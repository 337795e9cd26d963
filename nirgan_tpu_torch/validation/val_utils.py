"""Validation helpers (reference ``validation_utils/val_utils.py``): the
port's own copy of ``nirgan_tpu/validation/val_utils.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["crop_center"]


def crop_center(im, target_height: int):
    """Center square crop of a (C,H,W) or (H,W) array (reference
    ``val_utils.py:20-41`` semantics, including 2-D passthrough)."""
    im = np.asarray(im)
    was_2d = im.ndim == 2
    if was_2d:
        im = im[None]
    assert im.ndim == 3, f"Expected 3D array, got shape {im.shape}"
    c, h, w = im.shape
    t = target_height
    assert t <= h and t <= w, "Target size must be <= image size"
    y, x = (h - t) // 2, (w - t) // 2
    out = im[:, y:y + t, x:x + t]
    return out[0] if was_2d else out
