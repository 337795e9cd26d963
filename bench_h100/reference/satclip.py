"""Plain SatCLIP location tower, after the upstream SatCLIP
``location_encoder.py`` and its sympy-generated spherical harmonics: (lon,
lat) -> the L^2 real harmonics of phi = lon + 180 deg, theta = lat + 90 deg
(l < L, m = -l .. l; the generator's convention: the m = 0 terms times pi,
the others times (-1)^|m| against the textbook form) -> a SIREN (sin(30 x)
first, sin(x) after, a linear head), float64.  The associated Legendre
functions come from ``scipy.special.lpmv``; the pixel centres' lon/lat from
an inverse transverse Mercator of the UTM zone (a copy of the Krüger series
the program's GeoTIFF module uses)."""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import lpmv

W0_FIRST, W0 = 30.0, 1.0


def harmonics(lonlat: np.ndarray, n: int = 10) -> np.ndarray:
    """(B, 2) degrees -> (B, n^2) float64."""
    lon, lat = lonlat[:, 0].astype(np.float64), lonlat[:, 1].astype(np.float64)
    phi = np.deg2rad(lon + 180.0)
    cos_t = np.cos(np.deg2rad(lat + 90.0))
    cols = []
    for l in range(n):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) * math.factorial(l - am)
                             / (4 * math.pi * math.factorial(l + am)))
            p = lpmv(am, l, cos_t)
            if m == 0:
                cols.append(math.pi * norm * p)
            else:
                trig = np.cos(am * phi) if m > 0 else np.sin(am * phi)
                cols.append((-1.0) ** am * math.sqrt(2.0) * norm * p * trig)
    return np.stack(cols, axis=1)


def siren_weights(seed: int, device, n: int = 10, hidden: int = 256, layers: int = 2,
                  embed: int = 256) -> list:
    """[(W (in, out), b)] float64 numpy, the reference initialisation
    (U(-1/in, 1/in) first, U(-sqrt(6/in)/w0, sqrt(6/in)/w0) after), drawn on
    the device from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = [n * n] + [hidden] * layers + [embed]
    out = []
    for i in range(len(dims) - 1):
        s = 1.0 / dims[i] if i == 0 else math.sqrt(6.0 / dims[i]) / W0
        w = (torch.rand((dims[i], dims[i + 1]), generator=gen, device=device,
                        dtype=torch.float64) * 2 - 1) * s
        b = (torch.rand((dims[i + 1],), generator=gen, device=device,
                        dtype=torch.float64) * 2 - 1) * s
        out.append((w.cpu().numpy(), b.cpu().numpy()))
    return out


def embed(weights: list, lonlat: np.ndarray, dtype=np.float64) -> np.ndarray:
    """(B, 2) -> (B, embed) float32 (``dtype`` inside: the harmonics, the
    weights and every layer)."""
    n = int(round(math.sqrt(weights[0][0].shape[0])))
    x = harmonics(np.asarray(lonlat, np.float64), n).astype(dtype)
    for i, (w, b) in enumerate(weights):
        x = x @ w.astype(dtype) + b.astype(dtype)
        if i < len(weights) - 1:
            x = np.sin((W0_FIRST if i == 0 else W0) * x)
    return x.astype(np.float32)


def utm_to_lonlat(epsg: int, x, y):
    """Inverse WGS84 transverse Mercator for UTM zones (EPSG 326xx north,
    327xx south), Krüger series to n^4."""
    zone, north = epsg % 100, epsg // 100 == 326
    a, f, k0 = 6378137.0, 1 / 298.257223563, 0.9996
    n_ = f / (2 - f)
    big_a = a / (1 + n_) * (1 + n_ ** 2 / 4 + n_ ** 4 / 64)
    x = np.asarray(x, np.float64) - 500000.0
    y = np.asarray(y, np.float64) - (0.0 if north else 10000000.0)
    xi, eta = y / (k0 * big_a), x / (k0 * big_a)
    beta = [n_ / 2 - 2 * n_ ** 2 / 3 + 37 * n_ ** 3 / 96 - n_ ** 4 / 360,
            n_ ** 2 / 48 + n_ ** 3 / 15 - 437 * n_ ** 4 / 1440,
            17 * n_ ** 3 / 480 - 37 * n_ ** 4 / 840,
            4397 * n_ ** 4 / 161280]
    xi_p, eta_p = xi, eta
    for j, b in enumerate(beta, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    delta = [2 * n_ - 2 * n_ ** 2 / 3 - 2 * n_ ** 3 + 116 * n_ ** 4 / 45,
             7 * n_ ** 2 / 3 - 8 * n_ ** 3 / 5 - 227 * n_ ** 4 / 45,
             56 * n_ ** 3 / 15 - 136 * n_ ** 4 / 35,
             4279 * n_ ** 4 / 630]
    phi = chi + sum(d * np.sin(2 * j * chi) for j, d in enumerate(delta, start=1))
    lam0 = np.deg2rad(-183.0 + 6.0 * zone)
    lam = lam0 + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.rad2deg(lam), np.rad2deg(phi)
