"""Train/val metric suite, counterpart of ``nirgan_tpu/losses/metrics.py``
(reference ``utils/calculate_metrics.py:6-37``): L1, L2, PSNR (max 1.0) and
SSIM (Gaussian window 5), computed on the device; only the scalars go to the
host."""

from __future__ import annotations

from typing import Optional

import torch

from nirgan_tpu_torch.losses.pixel import l1_loss, mse_loss, psnr, ssim


def calculate_metrics(pred: torch.Tensor, target: torch.Tensor,
                      phase: str = "train",
                      mask: Optional[torch.Tensor] = None) -> dict:
    """Metric dict over the batch.  ``mask`` (B,) marks the valid rows of a
    padded batch; padded rows drop out of every mean."""
    if mask is None:
        return {
            f"{phase}/L1": l1_loss(pred, target),
            f"{phase}/L2": mse_loss(pred, target),
            f"{phase}/PSNR": psnr(pred, target, 1.0),
            f"{phase}/SSIM": ssim(pred, target, window_size=5,
                                  max_val=1.0).mean(),
        }
    w = mask.float()
    wsum = torch.clamp(w.sum(), min=1.0)

    def wmean(per_sample):
        return torch.sum(per_sample * w) / wsum

    d = pred.float() - target.float()
    red = tuple(range(1, d.dim()))
    l2 = wmean(torch.square(d).mean(dim=red))
    return {
        f"{phase}/L1": wmean(torch.abs(d).mean(dim=red)),
        f"{phase}/L2": l2,
        f"{phase}/PSNR": 10.0 * torch.log10(1.0 / l2),
        f"{phase}/SSIM": wmean(ssim(pred, target, window_size=5,
                                    max_val=1.0).mean(dim=red)),
    }
