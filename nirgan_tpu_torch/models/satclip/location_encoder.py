"""SatCLIP location encoder: SH positional features -> SIREN -> embedding,
counterpart of ``nirgan_tpu/models/satclip/location_encoder.py`` (reference
``model/satclip/location_encoder.py:73-151, 267-275``).

A SirenNet whose first layer uses w0 = 30, hidden layers w0 = 1, and whose
last layer is a plain linear map.  The encoder is used frozen, in float64
(the reference runs it under ``no_grad`` in ``.double()``,
``satclip_wrapper.py:29-34``), and returns float32.  The seeded fallback
draws its weights from a numpy ``Generator`` in the JAX package's order, so
both packages hold the same tower from the same seed.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from nirgan_tpu_torch.models.satclip.spherical_harmonics import (
    embedding_dim,
    sh_features,
)

__all__ = ["LocationEncoder", "siren_init"]


def siren_init(rng: np.random.Generator, dim_in: int, dim_out: int,
               is_first: bool, w0: float, c: float = 6.0):
    """torch Siren init (``location_encoder.py:137-144``): U(-s, s) with
    s = 1/dim_in for the first layer else sqrt(c/dim_in)/w0; bias same s.
    Returns (W (in, out), b) as float64 numpy arrays."""
    s = (1.0 / dim_in) if is_first else (math.sqrt(c / dim_in) / w0)
    w = rng.uniform(-s, s, size=(dim_in, dim_out))
    b = rng.uniform(-s, s, size=(dim_out,))
    return w, b


class LocationEncoder(nn.Module):
    """Frozen (lon, lat) -> R^embed_dim encoder.  ``weights``: [(W (in, out),
    b), ...] as numpy arrays, the sine layers then the linear head; they
    become float64 buffers ``weight{i}`` / ``bias{i}``: no optimizer sees them."""

    def __init__(self, weights: Sequence[tuple], legendre_polys: int = 10,
                 w0: float = 1.0, w0_initial: float = 30.0,
                 convention: str = "analytic"):
        super().__init__()
        if not weights:
            raise ValueError("LocationEncoder needs at least the linear head")
        self.legendre_polys = int(legendre_polys)
        self.w0, self.w0_initial = float(w0), float(w0_initial)
        self.convention = convention
        self.n_layers = len(weights)
        for i, (w, b) in enumerate(weights):
            self.register_buffer(f"weight{i}", torch.from_numpy(
                np.array(w, np.float64, order="C")))
            self.register_buffer(f"bias{i}", torch.from_numpy(
                np.array(b, np.float64, order="C")))

    @property
    def embed_dim(self) -> int:
        return int(getattr(self, f"bias{self.n_layers - 1}").numel())

    # ------------------------------------------------------------------ init
    @classmethod
    def create(cls, seed: int = 0, legendre_polys: int = 10,
               dim_hidden: int = 256, num_layers: int = 2,
               embed_dim: int = 256, w0: float = 1.0,
               w0_initial: float = 30.0,
               convention: str = "analytic") -> "LocationEncoder":
        """The reference architecture with weights drawn from ``seed``."""
        rng = np.random.default_rng(seed)
        dims = [embedding_dim(legendre_polys)] + [dim_hidden] * num_layers
        ws = [siren_init(rng, dims[i], dims[i + 1], i == 0,
                         w0_initial if i == 0 else w0)
              for i in range(num_layers)]
        ws.append(siren_init(rng, dim_hidden, embed_dim, False, w0))
        return cls(ws, legendre_polys, w0, w0_initial, convention)

    @classmethod
    def from_torch_state_dict(cls, sd: Mapping, prefix: str = "model.location.nnet.",
                              **kw) -> "LocationEncoder":
        """Map reference SIREN keys (``layers.{i}.weight/bias`` and
        ``last_layer.weight/bias``, torch (out, in) layout; numpy arrays)
        onto this encoder."""
        layers = []
        i = 0
        while f"{prefix}layers.{i}.weight" in sd:
            layers.append((np.asarray(sd[f"{prefix}layers.{i}.weight"], np.float64).T,
                           np.asarray(sd[f"{prefix}layers.{i}.bias"], np.float64)))
            i += 1
        last = (np.asarray(sd[f"{prefix}last_layer.weight"], np.float64).T,
                np.asarray(sd[f"{prefix}last_layer.bias"], np.float64))
        polys = (int(round(math.sqrt(layers[0][0].shape[0]))) if layers
                 else int(round(math.sqrt(last[0].shape[0]))))
        return cls(layers + [last], legendre_polys=polys, **kw)

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward64(self, lonlat: torch.Tensor) -> torch.Tensor:
        """(B, 2) lon/lat degrees on the tower's device -> (B, embed_dim)
        in float64."""
        x = sh_features(lonlat.to(torch.float64), self.legendre_polys,
                        self.convention)
        for i in range(self.n_layers):
            x = x @ getattr(self, f"weight{i}") + getattr(self, f"bias{i}")
            if i < self.n_layers - 1:  # the last layer has no activation
                x = torch.sin((self.w0_initial if i == 0 else self.w0) * x)
        return x

    def forward(self, lonlat: torch.Tensor) -> torch.Tensor:
        """``forward64`` cast to float32, as the reference casts double ->
        float (``satclip_wrapper.py:29-34``)."""
        return self.forward64(lonlat).to(torch.float32)

    def encode(self, lonlat) -> np.ndarray:
        """(B, 2) numpy lon/lat -> (B, embed_dim) float32 numpy."""
        return self(torch.from_numpy(np.asarray(lonlat, dtype=np.float64))).numpy()

    def param_count(self) -> int:
        return sum(int(b.numel()) for b in self.buffers())
