"""Real spherical-harmonic features of (lon, lat), counterpart of
``nirgan_tpu/models/satclip/spherical_harmonics.py`` on float64 tensors.

The closed-form associated-Legendre recurrence (reference
``spherical_harmonics_closed_form.py:8-40``), run for all orders m at once
on (B, L) matrices, and the L^2 terms assembled from tables of indices and
constant factors: in eager PyTorch an operation costs microseconds whatever
its size, and this runs once a batch beside the train step.

Two conventions, because the reference's sympy generator
(``spherical_harmonics_generate_ylms.py:21-33``) emits formulas that differ
from the closed form:

  * m == 0 terms: the generator writes ``sqrt((2l+1)/4 * pi)``, the closed
    form's ``sqrt((2l+1)/(4 pi))`` scaled by pi.
  * m != 0 terms: the generator multiplies by (-1)^m on top of sympy's
    Condon-Shortley-phased P_l^m, a net (-1)^|m| against the closed form.

The published SatCLIP checkpoints were trained with the *analytic*
convention, so that is the default; ``closed-form`` gives the textbook
normalisation.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["sh_features", "embedding_dim"]


def embedding_dim(legendre_polys: int) -> int:
    return legendre_polys * legendre_polys


def _renorm(l: int, m: int) -> float:
    return math.sqrt(
        (2.0 * l + 1.0) * math.factorial(l - m) / (4.0 * math.pi * math.factorial(l + m))
    )


def _assoc_legendre_table(n: int, x: torch.Tensor) -> torch.Tensor:
    """x (B,) -> (B, n, n): entry [:, t, m] is P_{m+t}^m(x) with
    Condon-Shortley phase, by the stable upward recurrence of the reference
    (``spherical_harmonics_closed_form.py:8-40``) run for every order m at
    once: column m sees the operations, in the order, that a scalar
    recurrence for (l, m) alone would apply (a factor of exactly 1 where a
    column has nothing to do), so the values are the same."""
    m = torch.arange(n, dtype=x.dtype, device=x.device)
    x = x[:, None]
    pmm = torch.ones_like(x).expand(-1, n)
    somx2 = torch.sqrt((1 - x) * (1 + x))
    fact = 1.0
    for k in range(1, n):  # P_m^m: m factors of -(2k - 1) sqrt(1 - x^2)
        due = m >= k
        pmm = pmm * torch.where(due, -fact, 1.0) * torch.where(due, somx2, 1.0)
        fact += 2.0
    rows = [pmm]
    if n > 1:
        pmmp1 = x * (2.0 * m + 1.0) * pmm
        rows.append(pmmp1)
        for t in range(2, n):  # l = m + t
            pll = ((2.0 * (m + t) - 1.0) * x * pmmp1 - (2.0 * m + t - 1.0) * pmm) / t
            pmm, pmmp1 = pmmp1, pll
            rows.append(pll)
    return torch.stack(rows, dim=1)


@functools.lru_cache(maxsize=8)
def _term_plan(n: int, convention: str) -> tuple:
    """For the n^2 terms in the order l = 0 .. n-1, m = -l .. l: the index
    of each term's P_l^|m| in the flattened table, of its trigonometric
    factor in [1, cos(k phi) for k < n, sin(k phi) for k < n], and its two
    constant factors (the normalisation, and the analytic convention's pi
    or sign)."""
    legendre, trig, norm, quirk = [], [], [], []
    for l in range(n):
        for m in range(-l, l + 1):
            am = abs(m)
            legendre.append((l - am) * n + am)
            trig.append(0 if m == 0 else (1 + am if m > 0 else 1 + n + am))
            norm.append(_renorm(l, 0) if m == 0 else math.sqrt(2.0) * _renorm(l, am))
            analytic = math.pi if m == 0 else (-1.0) ** am
            quirk.append(analytic if convention == "analytic" else 1.0)
    return (torch.tensor(legendre), torch.tensor(trig),
            torch.tensor(norm, dtype=torch.float64),
            torch.tensor(quirk, dtype=torch.float64))


def sh_features(lonlat: torch.Tensor, legendre_polys: int = 10,
                convention: str = "analytic") -> torch.Tensor:
    """(B, 2) lon/lat degrees -> (B, L^2) SH features in lonlat's dtype
    (float64 on the frozen path), ordered l = 0 .. L-1, m = -l .. l.  Angle
    mapping as the reference (``spherical_harmonics.py:27-42``): phi =
    deg2rad(lon + 180), theta = deg2rad(lat + 90).  Every order runs through
    the recurrence at once and every term takes its factors from a table,
    so the frozen tower costs about a hundred small operations a batch
    whatever L^2 is; each term's arithmetic is the JAX package's."""
    if convention not in ("analytic", "closed-form"):
        raise ValueError(f"unknown convention {convention!r}")
    n = legendre_polys
    lon, lat = lonlat[:, 0], lonlat[:, 1]
    phi = (lon + 180.0) * (math.pi / 180.0)
    theta = (lat + 90.0) * (math.pi / 180.0)
    which_p, which_trig, norm, quirk = (
        t.to(lonlat.device) for t in _term_plan(n, convention))
    table = _assoc_legendre_table(n, torch.cos(theta)).flatten(1)
    angles = torch.arange(n, dtype=lonlat.dtype, device=lonlat.device) * phi[:, None]
    trig = torch.cat([torch.ones_like(phi)[:, None], torch.cos(angles),
                      torch.sin(angles)], dim=1)
    y = norm.to(lonlat.dtype) * table[:, which_p] * trig[:, which_trig]
    return y * quirk.to(lonlat.dtype)
