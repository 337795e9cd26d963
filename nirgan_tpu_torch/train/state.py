"""The train state, counterpart of ``nirgan_tpu/train/state.py``: the step
counter, the two optimizers over the task's networks (reference
``model/pix2pix.py:485-492``) and the dropout's random stream.

Adam(lr, betas=(beta1, 0.999), eps=1e-8) on the f32 params is the math of
the JAX package's ``optax.scale_by_adam`` scaled by the live LR.  The
learning rates live in the optimizers' param groups, where the host-side
plateau schedulers rewrite them between steps.  The batch norms' running
statistics, which the JAX state carries as ``stats_g`` / ``stats_d``, live
in the networks' buffers; the JAX state's ``rng``, split each step for the
dropout, is a ``torch.Generator`` on the task's device whose state moves on
with each draw.  A task without a discriminator (the baselines) has no
``opt_d``: its ``lr_d`` is ``lr_g``, as the JAX baseline state keeps one to
give the trainer the same surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["TrainState", "adam_for", "check_param_dtype"]


def check_param_dtype(tpu) -> None:
    """The port keeps f32 parameters (the shipped configs' setting);
    ``tpu.param_dtype`` other than float32 is not ported (ROADMAP A8)."""
    name = str(tpu.get("param_dtype", "float32"))
    if name != "float32":
        raise NotImplementedError(f"tpu.param_dtype: {name} is not ported "
                                  "(f32 parameters only; ROADMAP A8)")


def adam_for(module: torch.nn.Module, lr: float,
             beta1: float = 0.5) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(beta1, 0.999),
                            eps=1e-8)


@dataclass
class TrainState:
    """Completed train steps, the G and D optimizers and the dropout's
    generator; the parameters themselves are the task's ``netG`` and
    ``netD``."""

    step: int
    opt_g: torch.optim.Adam
    opt_d: Optional[torch.optim.Adam] = None
    rng: Optional[torch.Generator] = None

    @property
    def lr_g(self) -> float:
        return float(self.opt_g.param_groups[0]["lr"])

    @property
    def lr_d(self) -> float:
        opt = self.opt_d if self.opt_d is not None else self.opt_g
        return float(opt.param_groups[0]["lr"])

    def set_lr(self, lr_g: float, lr_d: float) -> None:
        for opt, lr in ((self.opt_g, lr_g), (self.opt_d, lr_d)):
            for group in (opt.param_groups if opt is not None else ()):
                group["lr"] = float(lr)

