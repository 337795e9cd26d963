"""Losses and metrics, counterpart of ``nirgan_tpu/losses``: the GAN
objectives, the pixel losses, the spectral-index losses and the train/val
metric suite, all reduced in f32 on NHWC tensors."""

from nirgan_tpu_torch.losses.gan import gan_loss, gradient_penalty
from nirgan_tpu_torch.losses.metrics import calculate_metrics
from nirgan_tpu_torch.losses.pixel import (
    emd_loss,
    l1_loss,
    mse_loss,
    psnr,
    ssim,
    ssim_loss,
)
from nirgan_tpu_torch.losses.rs_indices import RemoteSensingIndices

__all__ = ["gan_loss", "gradient_penalty", "calculate_metrics", "l1_loss", "mse_loss", "psnr",
           "ssim", "ssim_loss", "emd_loss", "RemoteSensingIndices"]
