"""Losses and metrics, counterpart of ``nirgan_tpu/losses``: the GAN
objectives, the pixel losses and the train/val metric suite, all reduced in
f32 on NHWC tensors."""

from nirgan_tpu_torch.losses.gan import gan_loss
from nirgan_tpu_torch.losses.metrics import calculate_metrics
from nirgan_tpu_torch.losses.pixel import l1_loss, mse_loss, psnr, ssim

__all__ = ["gan_loss", "calculate_metrics", "l1_loss", "mse_loss", "psnr",
           "ssim"]
