"""GAN objectives, counterpart of ``nirgan_tpu/losses/gan.py`` (reference
``GANLoss`` and ``cal_gradient_penalty``, ``model/networks.py:210-313``):
each mode of ``gan_loss`` is one elementwise expression and a mean against
a scalar label, in f32; ``gradient_penalty`` is the WGAN-GP term, a library
function the fused step does not call (as in the JAX package)."""

from __future__ import annotations

from typing import Callable, Optional

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


def interpolation_weights(n: int, ndim: int, generator: Optional[torch.Generator],
                          device) -> torch.Tensor:
    """The mixed penalty's alpha: (n, 1, ...) f32 draws from U[0, 1), one a
    sample, from ``generator`` (on ``device``)."""
    return torch.rand((n,) + (1,) * (ndim - 1), generator=generator,
                      device=device, dtype=torch.float32)


def gradient_penalty(net_d: Callable[[torch.Tensor], torch.Tensor],
                     real_data: torch.Tensor, fake_data: torch.Tensor,
                     gp_type: str = "mixed", constant: float = 1.0,
                     lambda_gp: float = 10.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """WGAN-GP penalty ``lambda_gp * mean((|grad_x D(x)|_2 - constant)^2)``
    at x = real, fake or (``mixed``) alpha real + (1 - alpha) fake, the
    gradient of the summed logits taken with ``create_graph=True`` so that
    the penalty trains D; 1e-16 is added to the gradient before the norm,
    as in the reference.  The penalty trains a D with the instance norm:
    the norm's backward (kernel B4 on a card) is itself differentiable, its
    second-order terms in PyTorch ops (``ops/instance_norm.py``)."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real_data.device)
    if gp_type == "real":
        interp = real_data
    elif gp_type == "fake":
        interp = fake_data
    elif gp_type == "mixed":
        alpha = interpolation_weights(real_data.shape[0], real_data.dim(),
                                      generator, real_data.device)
        interp = alpha * real_data + (1.0 - alpha) * fake_data
    else:
        raise NotImplementedError(f"{gp_type} not implemented")
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(net_d(interp).float().sum(), interp,
                                   create_graph=True)
    flat = (grads + 1e-16).reshape(grads.shape[0], -1).float()
    norms = torch.sqrt(torch.sum(torch.square(flat), dim=1))
    return torch.mean(torch.square(norms - constant)) * lambda_gp
