"""Per-sample metrics of the geographic validation sweep, counterpart of
``nirgan_tpu/validation/per_sample_metrics.py``: SSIM-11, PSNR, L1, L2 and
the NDVI / NDWI / EVI L1 errors of each sample of a batch, as (B,) f32
vectors on the inputs' device.

The reference runs its sweep at batch 1 on host tensors
(``spider_validation_callback.py:28-68``); here, as in the JAX package, a
batch is one program of per-sample reductions.  No kernel of the port's
stands behind it: a few blurs and reductions a batch, PyTorch's own ops.
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.losses.pixel import ssim
from nirgan_tpu_torch.losses.rs_indices import RemoteSensingIndices

__all__ = ["per_sample_metrics"]

# index mode with the loss-mode epsilon: the reference's per-sample columns
# come from RemoteSensingIndices(mode='loss', criterion='l1') calls
# (spider_validation_callback.py:52-54), i.e. eps=1e-6 inside the indices.
_RS = RemoteSensingIndices(mode="index", eps=1e-6)


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.float(), dim=(1, 2, 3))


@torch.no_grad()
def per_sample_metrics(rgb: torch.Tensor, nir: torch.Tensor,
                       pred: torch.Tensor) -> dict:
    """NHWC batches -> dict of (B,) per-sample metric vectors."""
    diff = pred.float() - nir.float()
    l1 = _per_sample_mean(torch.abs(diff))
    l2 = _per_sample_mean(torch.square(diff))
    psnr = 10.0 * torch.log10(1.0 / l2)
    ssim_v = torch.mean(ssim(nir, pred, window_size=11), dim=(1, 2, 3))

    out = {"l1": l1, "l2": l2, "psnr": psnr, "ssim": ssim_v}
    for name in ("ndvi", "ndwi", "evi"):
        a, b = getattr(_RS, f"{name}_calculation")(rgb, nir, pred)
        out[f"l1_{name}"] = _per_sample_mean(torch.abs(a - b))
    return out
