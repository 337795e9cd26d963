"""The train state, counterpart of ``nirgan_tpu/train/state.py``: the step
counter and the two optimizers over the task's networks (reference
``model/pix2pix.py:485-492``).

Adam(lr, betas=(beta1, 0.999), eps=1e-8) on the f32 params is the math of
the JAX package's ``optax.scale_by_adam`` scaled by the live LR.  The
learning rates live in the optimizers' param groups, where the host-side
plateau schedulers rewrite them between steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["TrainState", "adam_for"]


def adam_for(module: torch.nn.Module, lr: float,
             beta1: float = 0.5) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(beta1, 0.999),
                            eps=1e-8)


@dataclass
class TrainState:
    """Completed train steps and the G and D optimizers; the parameters
    themselves are the task's ``netG`` and ``netD``."""

    step: int
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam

    @property
    def lr_g(self) -> float:
        return float(self.opt_g.param_groups[0]["lr"])

    @property
    def lr_d(self) -> float:
        return float(self.opt_d.param_groups[0]["lr"])

    def set_lr(self, lr_g: float, lr_d: float) -> None:
        for opt, lr in ((self.opt_g, lr_g), (self.opt_d, lr_d)):
            for group in opt.param_groups:
                group["lr"] = float(lr)

