"""GAN objectives, counterpart of ``nirgan_tpu/losses/gan.py:17-37``
(reference ``GANLoss``, ``model/networks.py:210-276``): each mode is one
elementwise expression and a mean against a scalar label, in f32.
``gradient_penalty`` is not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             gan_mode: str = "lsgan") -> torch.Tensor:
    """lsgan: MSE against the label (1 real, 0 fake); vanilla: BCE with
    logits against it; wgangp: -mean(prediction) for real, +mean for
    fake."""
    pred = prediction.float()
    target = 1.0 if target_is_real else 0.0
    if gan_mode == "lsgan":
        return torch.mean(torch.square(pred - target))
    if gan_mode == "vanilla":
        # max(x, 0) - x t + log(1 + exp(-|x|)), the JAX expression
        return torch.mean(F.relu(pred) - pred * target
                          + torch.log1p(torch.exp(-pred.abs())))
    if gan_mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")
