"""SatCLIP wrapper: the user-facing "coords -> 256-d embedding" handle,
counterpart of ``nirgan_tpu/models/satclip/wrapper.py`` (reference
``SatClIP_wrapper``, ``model/satclip/satclip_wrapper.py:7-38``, and
``get_satclip``, ``load.py:3-17``).

Loads a torch Lightning SatCLIP checkpoint when the file exists (reading
its ``hyper_parameters`` for the convention, as the reference loader does)
and otherwise warns and falls back to the reference architecture with
weights drawn from a seed: the published checkpoint is not in the
repository.  A directory is a pretrain run: the port's
``python -m nirgan_tpu_torch.pretrain_satclip`` writes ``satclip.ckpt`` in
the Lightning layout there, which loads as a file does.  A directory
without one is an orbax checkpoint of the JAX package's
``pretrain_satclip.py``; reading it needs that package, so it raises here.
Only the reference's spherical-harmonics / SIREN family fits the frozen
encoder: a checkpoint of another family raises, as the JAX wrapper refuses
one (``nirgan_tpu/models/satclip/wrapper.py:41-46``).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from nirgan_tpu_torch.models.satclip.location_encoder import LocationEncoder

__all__ = ["SatClipWrapper", "get_satclip_loc_encoder", "CKPT_NAME"]

CKPT_NAME = "satclip.ckpt"  # the checkpoint's name in a pretrain run directory


def get_satclip_loc_encoder(ckpt_path: Optional[str], seed: int = 0) -> LocationEncoder:
    """Lightweight loader (reference ``load_lightweight.py:5-35``): just the
    frozen location encoder of a Lightning SatCLIP checkpoint."""
    return SatClipWrapper(ckpt_path, seed=seed).encoder


class SatClipWrapper:
    def __init__(self, satclip_path: Optional[str] = None, seed: int = 0):
        self.loaded_from = None
        path = satclip_path
        if path and os.path.isdir(path):
            path = os.path.join(path, CKPT_NAME)
            if not os.path.isfile(path):
                raise NotImplementedError(
                    f"{satclip_path}: an orbax checkpoint directory needs the JAX "
                    "package to be read; pass a torch SatCLIP .ckpt file")
        if path and os.path.exists(path):
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            hp = ckpt.get("hyper_parameters", {})
            if (hp.get("le_type", "sphericalharmonics") != "sphericalharmonics"
                    or hp.get("pe_type", "siren") != "siren"):
                raise NotImplementedError(
                    f"SatCLIP checkpoint uses {hp.get('le_type')}/"
                    f"{hp.get('pe_type')}; only the reference's "
                    "sphericalharmonics/siren family loads into the frozen encoder")
            sd = {k: np.asarray(v.detach().cpu().numpy())
                  for k, v in ckpt.get("state_dict", {}).items()
                  if hasattr(v, "detach")}
            self.encoder = LocationEncoder.from_torch_state_dict(
                sd, convention="analytic"
                if hp.get("harmonics_calculation", "analytic") == "analytic"
                else "closed-form")
            self.loaded_from = satclip_path
        else:
            if satclip_path:
                warnings.warn(
                    f"SatCLIP checkpoint not found at {satclip_path!r}; "
                    "using a randomly-initialised reference-architecture "
                    "location encoder (embeddings will not match published "
                    "checkpoints).")
            self.encoder = LocationEncoder.create(seed=seed)

    def embed(self, coords) -> torch.Tensor:
        """(B, 2) lon/lat (numpy) -> (B, embed_dim) float32 tensor on the
        host, float64 inside."""
        return self.encoder(torch.from_numpy(np.asarray(coords, dtype=np.float64)))

    def predict(self, coords) -> np.ndarray:
        """``embed`` as float32 numpy, the JAX wrapper's contract
        (``satclip_wrapper.py:31``'s ``.double()``)."""
        return self.embed(coords).numpy()

    @property
    def embed_dim(self) -> int:
        return self.encoder.embed_dim
