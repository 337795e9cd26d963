"""Weight initialisers, counterpart of ``nirgan_tpu/ops/initializers.py``.

The pix2pix default N(0, 0.02) for conv weights, biases zero.  Draws come
from an explicit CPU ``torch.Generator`` and are copied to the parameter's
device, so one seed gives the same weights on every device.  The numbers
differ from ``jax.random`` for the same seed: parity tests hand both stacks
the same numpy weights instead.
"""

from __future__ import annotations

from typing import Callable

import torch

Init = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def normal(gain: float = 0.02) -> Init:
    def init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        draw = torch.empty(t.shape, dtype=torch.float32).normal_(
            0.0, gain, generator=generator)
        with torch.no_grad():
            return t.copy_(draw)

    return init


def get_initializer(init_type: str, init_gain: float = 0.02) -> Init:
    """String dispatch of the reference ``init_weights``; only "normal",
    the configs' choice, is ported so far."""
    if init_type == "normal":
        return normal(init_gain)
    raise NotImplementedError(f"initialization method [{init_type}] is not "
                              "ported yet")
