"""Bilinear resize with torch ``F.interpolate(align_corners=False)`` tap
weights in matrix form, counterpart of ``nirgan_tpu/ops/resize.py``.

Each 1-D resampling is a dense (out x in) matrix built on the host and
applied as two f32 contractions (rows, then columns), the same matrices the
JAX package folds into its programs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _src_coords(out_size: int, in_size: int) -> np.ndarray:
    # half-pixel (align_corners=False) source coordinates
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


@functools.lru_cache(maxsize=64)
def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    src = np.maximum(_src_coords(out_size, in_size), 0.0)  # torch clamps low
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, i0), 1.0 - w1)
    np.add.at(mat, (rows, i1), w1)
    return mat.astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), computed in f32 and returned in
    x's dtype."""
    _, h, w, _ = x.shape
    mh = torch.from_numpy(bilinear_matrix(h, out_h)).to(x.device)
    mw = torch.from_numpy(bilinear_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x.float())
    y = torch.einsum("ow,bhwc->bhoc", mw, y)
    return y.to(x.dtype).contiguous()
