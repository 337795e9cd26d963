"""Remote-sensing spectral-index losses on NHWC tensors, counterpart of
``nirgan_tpu/losses/rs_indices.py`` (reference
``utils/remote_sensing_indices.py:4-319``): six indices computed from (rgb,
nir, nir_pred), compared with L1 or L2 between the index images of the true
and of the predicted NIR.  The reference's documented quirks stay, so the
loss values agree with both stacks:

  * eps = 1e-6 in ``loss`` mode and exactly 0 in ``index`` mode, for NDVI
    and NDWI only; GNDVI and SAVI never add one; EVI adds it to the whole
    denominator in loss mode.
  * EVI's (nonstandard) denominator ``(NIR + C1) * (R - C2) * (B + L)`` with
    L, C1, C2, G = 1, 6, 7.5, 2.5.
  * GNDVI divides by ``NDVI + GREEN``, as the reference writes it.
  * MSAVI = (2 NIR + 1 - sqrt((2 NIR + 1)^2 - 8 (NIR - R))) / 2.

rgb (B, H, W, 3); nir and nir_pred (B, H, W, 1); a 3-D input gets a batch
dimension.  Everything is computed in f32 with PyTorch's own ops.
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.losses.pixel import l1_loss, mse_loss

LOG_NAMES = {
    "lambda_ndvi": "indices_loss/ndvi_error",
    "lambda_ndwi": "indices_loss/ndwi_error",
    "lambda_gndvi": "indices_loss/gndvi_error",
    "lambda_savi": "indices_loss/savi_error",
    "lambda_msavi": "indices_loss/msavi_error",
    "lambda_evi": "indices_loss/evi_error",
}

DEFAULT_WEIGHTS = {
    "lambda_ndvi": 0.333,
    "lambda_ndwi": 0.333,
    "lambda_evi": 0.333,
    "lambda_savi": 0.0,
    "lambda_msavi": 0.0,
    "lambda_gndvi": 0.0,
}


def _prep(*tensors: torch.Tensor) -> tuple:
    return tuple((t[None] if t.dim() == 3 else t).float() for t in tensors)


class RemoteSensingIndices:
    """mode: "loss" (the criterion's scalar) or "index" (the pair of index
    images); criterion: "l1" or "l2"."""

    def __init__(self, mode: str = "loss", criterion: str = "l1",
                 eps: float | None = None):
        if mode not in ("loss", "index"):
            raise AssertionError(
                f"Mode '{mode}' not implemented. 'loss', 'index' are supported.")
        self.mode = mode
        self.eps_override = eps
        if criterion == "l1":
            self.criterion = l1_loss
        elif criterion == "l2":
            self.criterion = mse_loss
        else:
            raise NotImplementedError(
                f"Criterion '{criterion}' not implemented. 'l1' or 'l2' are "
                "supported.")

    def _finish(self, idx_true: torch.Tensor, idx_pred: torch.Tensor):
        if self.mode == "loss":
            return self.criterion(idx_true, idx_pred)
        return idx_true, idx_pred

    @property
    def _eps(self) -> float:
        if self.eps_override is not None:
            return self.eps_override
        return 1e-6 if self.mode == "loss" else 0.0

    def ndvi_calculation(self, rgb, nir, nir_pred):
        """(NIR - R) / (NIR + R [+ eps])."""
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        red = rgb[..., 0:1]
        return self._finish((nir - red) / (nir + red + self._eps),
                            (nir_pred - red) / (nir_pred + red + self._eps))

    def ndwi_calculation(self, rgb, nir, nir_pred):
        """(NIR - G) / (NIR + G [+ eps])."""
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        green = rgb[..., 1:2]
        return self._finish((nir - green) / (nir + green + self._eps),
                            (nir_pred - green) / (nir_pred + green + self._eps))

    def gndvi_calculation(self, rgb, nir, nir_pred):
        """(NIR - G) / (NDVI + G), the reference's formula as written."""
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        red, green = rgb[..., 0:1], rgb[..., 1:2]
        ndvi = (nir - red) / (nir + red)
        ndvi_pred = (nir_pred - red) / (nir_pred + red)
        return self._finish((nir - green) / (ndvi + green),
                            (nir_pred - green) / (ndvi_pred + green))

    def savi_calculation(self, rgb, nir, nir_pred):
        """(1 + L) (NIR - R) / (NIR + R + L), L = 0.5."""
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        red = rgb[..., 0:1]
        return self._finish(1.5 * (nir - red) / (nir + red + 0.5),
                            1.5 * (nir_pred - red) / (nir_pred + red + 0.5))

    def msavi_calculation(self, rgb, nir, nir_pred):
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        red = rgb[..., 0:1]

        def msavi(n):
            return (2 * n + 1 - torch.sqrt((2 * n + 1) ** 2 - 8 * (n - red))) / 2

        return self._finish(msavi(nir), msavi(nir_pred))

    def evi_calculation(self, rgb, nir, nir_pred):
        l, c1, c2, g = 1.0, 6.0, 7.5, 2.5
        rgb, nir, nir_pred = _prep(rgb, nir, nir_pred)
        red, blue = rgb[..., 0:1], rgb[..., 2:3]
        eps = self._eps
        denom = (nir + c1) * (red - c2) * (blue + l) + eps
        denom_pred = (nir_pred + c1) * (red - c2) * (blue + l) + eps
        return self._finish(g * (nir - red) / denom,
                            g * (nir_pred - red) / denom_pred)

    def get_and_weight_losses(self, rgb, nir, nir_pred, loss_config=None,
                              mode: str = "loss"):
        """The weighted sum of the indices whose weight is > 0 ("loss") or
        every index under its ``indices_loss/*`` name ("logging_dict"),
        reference ``:23-71``."""
        if loss_config is None:
            loss_config = DEFAULT_WEIGHTS
        fns = {
            "lambda_ndvi": self.ndvi_calculation,
            "lambda_ndwi": self.ndwi_calculation,
            "lambda_gndvi": self.gndvi_calculation,
            "lambda_savi": self.savi_calculation,
            "lambda_msavi": self.msavi_calculation,
            "lambda_evi": self.evi_calculation,
        }
        if mode == "loss":
            total = 0.0
            for key, fn in fns.items():
                weight = float(loss_config.get(key, 0.0))
                if weight > 0.0:
                    total = total + weight * fn(rgb, nir, nir_pred)
            return total
        if mode == "logging_dict":
            return {LOG_NAMES[key]: fn(rgb, nir, nir_pred) for key, fn in fns.items()}
        raise NotImplementedError(
            f"Mode '{mode}' not implemented. 'loss' or 'logging_dict' are "
            "supported.")
