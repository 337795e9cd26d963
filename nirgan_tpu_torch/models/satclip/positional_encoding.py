"""The positional encodings of the SatCLIP stack, the port's own copy of
``nirgan_tpu/models/satclip/positional_encoding.py`` (reference
``model/satclip/positional_encoding/``): direct, cartesian3d, wrap, theory,
grid-and-sphere (grid / spherec / spherecplus / spherem / spheremplus),
spherical harmonics (analytic and closed-form conventions), discretized
spherical harmonics, and the trainable weighted spherical harmonics.

The frozen encoders are parameter-free coordinate transforms run on the
host in float64 (numpy; the spherical harmonics through the port's
``spherical_harmonics.sh_features`` on float64 CPU tensors), once a batch,
as the reference runs its location tower in ``.double()``.  Reference
quirks kept, as the JAX package keeps them: the grid and sphere encoders
repeat each frequency pair from the (freq, 2) tiling
(``grid_and_sphere.py:96-100``); the discretized lookup uses the reference's
two-tap interpolation, whose weights do not sum to one, and a unit-degree
index into a 360/359-degree-spaced grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from nirgan_tpu_torch.models.satclip.spherical_harmonics import (
    embedding_dim,
    sh_features,
)

__all__ = [
    "Direct", "Cartesian3D", "Wrap", "Theory", "GridAndSphere",
    "SphericalHarmonics", "WeightedSphericalHarmonics",
    "DiscretizedSphericalHarmonics", "get_positional_encoding",
]

_D2R = math.pi / 180.0


def cal_freq_list(freq_init: str, frequency_num: int, max_radius: float,
                  min_radius: float) -> np.ndarray:
    """Geometric (or random) frequency ladder (reference ``common.py``)."""
    if freq_init == "random":
        return np.random.random(frequency_num) * max_radius
    log_inc = math.log(max_radius / min_radius) / (frequency_num - 1.0)
    timescales = min_radius * np.exp(np.arange(frequency_num, dtype=float) * log_inc)
    return 1.0 / timescales


def _sh64(coords, legendre_polys: int, convention: str) -> np.ndarray:
    pts = torch.from_numpy(np.asarray(coords, np.float64))
    return sh_features(pts, legendre_polys, convention).numpy()


@dataclass
class Direct:
    embedding_dim: int = 2

    def __call__(self, coords):
        return np.asarray(coords) * _D2R - math.pi


@dataclass
class Cartesian3D:
    embedding_dim: int = 3

    def __call__(self, coords):
        c = np.asarray(coords) * _D2R
        lon, lat = c[:, 0], c[:, 1]
        return np.stack([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat),
                         np.sin(lat)], axis=1)


@dataclass
class Wrap:
    embedding_dim: int = 4

    def __call__(self, coords):
        c = np.asarray(coords) * _D2R
        lon, lat = c[:, 0], c[:, 1]
        return np.stack([np.cos(lon), np.sin(lon), np.cos(lat), np.sin(lat)], axis=1)


@dataclass
class Theory:
    """Three 120-degree-apart unit vectors x a frequency ladder, sin and cos
    interleaved (reference ``theory.py:11-90``)."""

    frequency_num: int = 16
    max_radius: float = 10000.0
    min_radius: float = 1000.0
    freq_init: str = "geometric"

    def __post_init__(self):
        self.freq_list = cal_freq_list(self.freq_init, self.frequency_num,
                                       self.max_radius, self.min_radius)
        self.embedding_dim = 2 * 3 * self.frequency_num
        self.unit_vecs = np.asarray([
            [1.0, 0.0],
            [-0.5, math.sqrt(3) / 2.0],
            [-0.5, -math.sqrt(3) / 2.0],
        ])

    def __call__(self, coords):
        c = np.asarray(coords, dtype=np.float64)
        angles = c @ self.unit_vecs.T                                 # (B, 3)
        ang6 = np.repeat(angles, 2, axis=1)                           # a a b b c c
        scaled = ang6[:, None, :] * self.freq_list[None, :, None]
        flat = scaled.reshape(c.shape[0], -1)                         # (B, 6f)
        even = np.sin(flat[:, 0::2])
        odd = np.cos(flat[:, 1::2])
        return np.stack([even, odd], axis=-1).reshape(c.shape[0], -1)


@dataclass
class GridAndSphere:
    """grid | spherec | spherecplus | spherem | spheremplus
    (reference ``grid_and_sphere.py:11-318``)."""

    frequency_num: int = 16
    max_radius: float = 0.01
    min_radius: float = 0.00001
    freq_init: str = "geometric"
    name: str = "grid"

    def __post_init__(self):
        self.freq_list = cal_freq_list(self.freq_init, self.frequency_num,
                                       self.max_radius, self.min_radius)
        dims = {"grid": 4, "spherec": 6, "spherecplus": 12,
                "spherem": 10, "spheremplus": 16}
        self.embedding_dim = dims[self.name] * self.frequency_num

    def __call__(self, coords):
        c = np.asarray(coords, dtype=np.float64)
        b = c.shape[0]
        f = self.frequency_num
        # raw coords broadcast to (B, 2, f, 2); the scaled ones x freq
        raw = np.broadcast_to(c[:, :, None, None], (b, 2, f, 2))
        scaled = raw * self.freq_list[None, None, :, None]
        lon, lat = scaled[:, 0], scaled[:, 1]            # (B, f, 2)
        lon_r, lat_r = raw[:, 0], raw[:, 1]

        if self.name == "grid":
            out = np.stack([np.sin(scaled[..., 0]), np.cos(scaled[..., 1])],
                           axis=-1)                       # (B, 2, f, 2)
            return out.reshape(b, -1)
        if self.name == "spherec":
            parts = [np.sin(lat), np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon)]
        elif self.name == "spherecplus":
            parts = [np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon),
                     np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon)]
        elif self.name == "spherem":
            parts = [np.sin(lat), np.cos(lat) * np.cos(lon_r),
                     np.cos(lat_r) * np.cos(lon), np.cos(lat) * np.sin(lon_r),
                     np.cos(lat_r) * np.sin(lon)]
        elif self.name == "spheremplus":
            parts = [np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon),
                     np.cos(lat) * np.cos(lon_r), np.cos(lat_r) * np.cos(lon),
                     np.cos(lat) * np.sin(lon_r), np.cos(lat_r) * np.sin(lon)]
        else:
            raise ValueError(self.name)
        return np.concatenate(parts, axis=-1).reshape(b, -1)


@dataclass
class SphericalHarmonics:
    legendre_polys: int = 10
    harmonics_calculation: str = "analytic"

    def __post_init__(self):
        self.embedding_dim = embedding_dim(self.legendre_polys)

    def __call__(self, coords):
        conv = ("closed-form" if self.harmonics_calculation == "closed-form"
                else "analytic")
        return _sh64(coords, self.legendre_polys, conv)


@dataclass
class DiscretizedSphericalHarmonics:
    """SH features tabulated on a 1-degree-ish lon/lat grid, looked up with
    the reference's two-tap interpolation (quirks kept: see the module
    docstring)."""

    legendre_polys: int = 10
    grid: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        self.embedding_dim = embedding_dim(self.legendre_polys)
        lon = np.linspace(-180.0, 180.0, 360)
        lat = np.linspace(-90.0, 90.0, 180)
        lons, lats = np.meshgrid(lon, lat)              # (180, 360)
        pts = np.stack([lons.ravel(), lats.ravel()], axis=-1)
        feats = _sh64(pts, self.legendre_polys, "analytic")
        ys = feats.T.reshape(self.embedding_dim, 180, 360)
        self.grid = np.transpose(ys, (0, 2, 1))          # (F, 360, 180)

    def __call__(self, coords):
        pts = np.asarray(coords, np.float64) + np.asarray([180.0, 90.0])
        img = self.grid
        rows, cols = img.shape[1], img.shape[2]
        fl = np.floor(pts).astype(np.int64)
        ce = np.ceil(pts).astype(np.int64)
        frac = pts - fl
        fl[:, 0] = np.clip(fl[:, 0], 0, rows - 1)
        fl[:, 1] = np.clip(fl[:, 1], 0, cols - 1)
        ce[:, 0] = np.clip(ce[:, 0], 0, rows - 1)
        ce[:, 1] = np.clip(ce[:, 1], 0, cols - 1)
        floor_px = img[:, fl[:, 0], fl[:, 1]]            # (F, B)
        ceil_px = img[:, ce[:, 0], ce[:, 1]]
        w_floor = (1 - frac[:, 0]) * (1 - frac[:, 1])
        w_ceil = frac[:, 0] * (1 - frac[:, 1])
        return (floor_px * w_floor[None] + ceil_px * w_ceil[None]).T


class WeightedSphericalHarmonics(nn.Module):
    """Trainable SH encoding (reference
    ``positional_encoding/spherical_harmonics_weighted.py``): the raw SH
    basis, closed form in f32, mixed into ``embedding_dim`` outputs by a
    learnable (L, L, E) coefficient tensor ``weight`` with the reference's
    triangular storage, including its wrap-around ``weight[-l, m]`` for
    m < 0.  Unreachable from ``get_positional_encoding`` upstream, as in
    the JAX package; ported for completeness."""

    def __init__(self, legendre_polys: int = 10, embedding_dim: int = 16,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.legendre_polys = int(legendre_polys)
        self.embedding_dim = int(embedding_dim)
        L = self.legendre_polys
        draw = torch.empty((L, L, self.embedding_dim)).normal_(
            0.0, 0.33, generator=generator)
        self.weight = nn.Parameter(draw.to(device))
        # (l, m) of each row of the coefficient matrix, in sh_features' order
        rows = [(l if m >= 0 else -l, m) for l in range(L) for m in range(-l, l + 1)]
        self.register_buffer("_l", torch.tensor([r[0] for r in rows], device=device),
                             persistent=False)
        self.register_buffer("_m", torch.tensor([r[1] for r in rows], device=device),
                             persistent=False)

    def forward(self, lonlat: torch.Tensor) -> torch.Tensor:
        cmat = self.weight[self._l, self._m]            # (L^2, E), negative wraps
        feats = sh_features(lonlat.to(torch.float32), self.legendre_polys,
                            "closed-form")
        return feats.to(cmat.dtype) @ cmat


def get_positional_encoding(name: str, legendre_polys: int = 10,
                            harmonics_calculation: str = "analytic",
                            min_radius: float = 1, max_radius: float = 360,
                            frequency_num: int = 10):
    """String dispatch (reference ``location_encoder.py:216-239``)."""
    if name == "direct":
        return Direct()
    if name == "cartesian3d":
        return Cartesian3D()
    if name == "sphericalharmonics":
        if harmonics_calculation == "discretized":
            return DiscretizedSphericalHarmonics(legendre_polys=legendre_polys)
        return SphericalHarmonics(legendre_polys=legendre_polys,
                                  harmonics_calculation=harmonics_calculation)
    if name == "theory":
        return Theory(min_radius=min_radius, max_radius=max_radius,
                      frequency_num=frequency_num)
    if name == "wrap":
        return Wrap()
    if name in ("grid", "spherec", "spherecplus", "spherem", "spheremplus"):
        return GridAndSphere(min_radius=min_radius, max_radius=max_radius,
                             frequency_num=frequency_num, name=name)
    raise ValueError(f"{name} not a known positional encoding.")
