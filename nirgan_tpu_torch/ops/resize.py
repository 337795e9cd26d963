"""Bilinear and bicubic resize with torch ``F.interpolate(
align_corners=False)`` tap weights in matrix form, counterpart of
``nirgan_tpu/ops/resize.py``.

The reference scales the injected location plane and the S2 NIR of the
synthesis pipeline bilinearly, and the concat route's embedding plane
bicubically (A = -0.75, edge-clamped taps, ``model/pix2pix.py:473``).  Each
1-D resampling is a dense (out x in) matrix built on the host and applied as
two f32 contractions (rows, then columns), the same matrices the JAX package
folds into its programs.  A matrix is copied to a device once and kept, so a
train step's resize waits for no copy.
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


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    src = _src_coords(out_size, in_size)  # NOT clamped (torch bicubic)
    i = np.floor(src).astype(np.int64)
    t = src - i
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for tap in range(-1, 3):
        idx = np.clip(i + tap, 0, in_size - 1)  # edge-clamped access
        np.add.at(mat, (rows, idx), _cubic_weight(t - tap))
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(matrix, in_size: int, out_size: int,
               device: torch.device) -> torch.Tensor:
    # a kept matrix may first be asked for while serving under
    # ``torch.inference_mode`` and later meet autograd in a train step: make
    # it a normal tensor whatever the mode
    with torch.inference_mode(False):
        return torch.from_numpy(matrix(in_size, out_size)).to(device)


def _apply_separable(x: torch.Tensor, matrix, out_h: int, out_w: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    mh = _on_device(matrix, h, out_h, x.device)
    mw = _on_device(matrix, w, out_w, x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x.float())
    y = torch.einsum("ow,bhwc->bhoc", mw, y)
    return y.to(x.dtype).contiguous()


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)`` on NHWC:
    (B, H, W, C) -> (B, out_h, out_w, C), computed in f32 and returned in
    x's dtype."""
    return _apply_separable(x, bilinear_matrix, out_h, out_w)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='bicubic', align_corners=False)`` on NHWC,
    computed in f32 and returned in x's dtype."""
    return _apply_separable(x, bicubic_matrix, out_h, out_w)
