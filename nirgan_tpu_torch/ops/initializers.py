"""Weight initialisers, counterpart of ``nirgan_tpu/ops/initializers.py``
(reference ``init_weights``, ``model/networks.py:68-99``): normal | xavier |
kaiming | orthogonal for conv and dense weights, N(0, 0.02) the pix2pix
default, biases zero; the batch norm's scale from N(1, 0.02); and torch's
own default for the baseline regressors.

Draws come from an explicit CPU ``torch.Generator`` and are copied to the
parameter's device, so one seed gives the same weights on every device.  The
numbers differ from ``jax.random`` for the same seed: parity tests hand both
stacks the same numpy weights instead, and hold the initialisers to the
JAX ones by their statistics.  Fans follow the JAX package's ``_fans`` on
its HWIO kernels: fan_in = kh kw Cin, fan_out = kh kw Cout, whichever torch
layout the weight has (OIHW for a conv, IOHW for a transposed conv, (out,
in) for a dense layer).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# init(weight, generator, transposed) -> weight, written in place
Init = Callable[..., torch.Tensor]


def _fans(shape, transposed: bool = False) -> tuple[int, int]:
    """(fan_in, fan_out) of a torch-layout weight: OIHW, IOHW when
    ``transposed``, or (out, in)."""
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        cin, cout = (shape[0], shape[1]) if transposed else (shape[1], shape[0])
        return cin * rf, cout * rf
    if len(shape) == 2:
        return shape[1], shape[0]
    raise ValueError(f"unsupported kernel shape {tuple(shape)}")


def _write(t: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(draw)


def _gauss(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).normal_(
        0.0, 1.0, generator=generator)


def normal(gain: float = 0.02) -> Init:
    def init(t: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> torch.Tensor:
        draw = torch.empty(t.shape, dtype=torch.float32).normal_(
            0.0, gain, generator=generator)
        return _write(t, draw)

    return init


def xavier_normal(gain: float = 0.02) -> Init:
    """N(0, gain sqrt(2 / (fan_in + fan_out)))."""
    def init(t: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> torch.Tensor:
        fan_in, fan_out = _fans(t.shape, transposed)
        std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
        return _write(t, std * _gauss(t.shape, generator))

    return init


def kaiming_normal() -> Init:
    """torch's ``kaiming_normal_(a=0, mode='fan_in')``: N(0, sqrt(2 /
    fan_in)); the gain is not used, as in the reference."""
    def init(t: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> torch.Tensor:
        fan_in, _ = _fans(t.shape, transposed)
        return _write(t, (2.0 / fan_in) ** 0.5 * _gauss(t.shape, generator))

    return init


def orthogonal(gain: float = 0.02) -> Init:
    """An orthogonal matrix times ``gain`` over (out, the rest) of the
    weight, the output channel first whatever the layout: rows orthonormal
    where there are fewer outputs than the rest, columns elsewhere (QR of a
    Gaussian matrix, signs fixed by R's diagonal, as torch's
    ``orthogonal_`` and ``jax.nn.initializers.orthogonal`` do)."""
    def init(t: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> torch.Tensor:
        out_first = t.transpose(0, 1) if transposed and t.dim() == 4 else t
        rows = out_first.shape[0]
        cols = out_first.numel() // rows
        a = _gauss((max(rows, cols), min(rows, cols)), generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        flat = (gain * q).reshape(out_first.shape)
        return _write(t, flat.transpose(0, 1) if out_first is not t else flat)

    return init


def lecun_normal() -> Init:
    """flax's default kernel init (``lecun_normal``): a normal truncated at
    two standard deviations, scaled to the variance 1 / fan_in (std
    sqrt(1 / fan_in) / 0.8796, the truncated normal's own std), drawn by
    the inverse of the normal's CDF."""
    def init(t: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> torch.Tensor:
        fan_in, _ = _fans(t.shape, transposed)
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
            (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
        u = torch.empty(t.shape, dtype=torch.float32).uniform_(
            lo, hi, generator=generator)
        draw = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return _write(t, std * draw.clamp(-2.0, 2.0))

    return init


def batchnorm_scale_init(t: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """The batch norm's scale from N(1, 0.02) (reference ``init_weights``,
    ``model/networks.py:94-96``, with the JAX package's fixed 0.02)."""
    return _write(t, 1.0 + 0.02 * _gauss(t.shape, generator))


def torch_default(t: torch.Tensor, generator: torch.Generator,
                  fan_in: int) -> torch.Tensor:
    """torch's default for ``nn.Linear`` and ``nn.Conv2d``
    (kaiming-uniform with a = sqrt(5)): U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    for the weight and for the bias alike."""
    bound = 1.0 / fan_in ** 0.5
    draw = torch.empty(t.shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)
    return _write(t, draw)


def get_initializer(init_type: str, init_gain: float = 0.02) -> Init:
    """String dispatch of the reference ``init_weights``
    (``model/networks.py:79-91``)."""
    if init_type == "normal":
        return normal(init_gain)
    if init_type == "xavier":
        return xavier_normal(init_gain)
    if init_type == "kaiming":
        return kaiming_normal()
    if init_type == "orthogonal":
        return orthogonal(init_gain)
    raise NotImplementedError(f"initialization method [{init_type}] is not "
                              "implemented")
