"""Pixel losses and image-quality terms on NHWC tensors, counterpart of
``nirgan_tpu/losses/pixel.py``: L1, MSE, PSNR as ``kornia.metrics.psnr``,
SSIM as ``kornia.metrics.ssim`` (Gaussian window, sigma 1.5, reflect-padded
"same" filtering as two depthwise 1-D convolutions) and its loss, and the
softmax-CDF earth mover's proxy of the reference's histogram loss
(``utils/losses.py:64-78``), in f32.  No TPU kernel stands behind any of
them: on a card they are PyTorch's own ops."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / mse_loss(pred, target))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64) - (window_size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(x: torch.Tensor, window_size: int,
                   sigma: float = 1.5) -> torch.Tensor:
    """Depthwise separable Gaussian filter on NCHW x, reflect-padded
    'same'."""
    c = x.shape[1]
    k = torch.from_numpy(_gaussian_kernel1d(window_size, sigma)).to(x.device)
    pad = window_size // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(xp, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(y, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         max_val: float = 1.0) -> torch.Tensor:
    """Per-pixel SSIM map (NHWC, the inputs' size), kornia's algorithm:
    E[x^2] - E[x]^2 variances and ``num / (den + 1e-12)``."""
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _gaussian_blur(x, window_size)
    mu_y = _gaussian_blur(y, window_size)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _gaussian_blur(x * x, window_size) - mu_xx
    sigma_y = _gaussian_blur(y * y, window_size) - mu_yy
    sigma_xy = _gaussian_blur(x * y, window_size) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return (num / (den + 1e-12)).permute(0, 2, 3, 1)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    """1 - mean SSIM (reference ``utils/losses.py:10-29``)."""
    return 1.0 - torch.mean(ssim(img1, img2, window_size))


def emd_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Softmax-CDF earth mover's proxy (reference ``utils/losses.py:64-78``):
    per sample, flatten, softmax, cumulative sum, then the mean |difference|
    of the two CDFs over the batch.  The reference's NaN/Inf asserts are
    left out, as in the JAX package."""
    p = pred.float().reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    return torch.mean(torch.abs(torch.cumsum(torch.softmax(p, dim=1), dim=1)
                                - torch.cumsum(torch.softmax(t, dim=1), dim=1)))
