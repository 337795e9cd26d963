"""U-Net generator, counterpart of ``nirgan_tpu/models/unet.py`` (reference
``model/networks.py:437-536``).

Nested blocks, built as the JAX module's ``_make_submodule`` builds them:
outermost [conv down | sub | relu, convT up, tanh], middle blocks [lrelu,
conv down, norm | sub | relu, convT up, norm (, dropout)], innermost
[lrelu, conv down | relu, convT up, norm]; every block but the outermost
concatenates its input with its output along the channels (the last axis
of the port's NHWC tensors).  The convs and transposed convs are k4 s2 p1
(``output_padding`` 0) on PyTorch's own convolutions, as the JAX package
runs them in XLA; each instance norm goes through
``ops.instance_norm.instance_norm`` (kernel B on a card, kernel B4 its
backward), with no ReLU or skip fused.  Dropout sits in the middle blocks at
8 ngf only, as in the reference.  Parameter names follow the JAX tree:
``unet.down``, ``unet.sub.downnorm``, ``unet.sub.sub.up`` ...
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nirgan_tpu_torch.models.layers import (
    Dropout,
    Norm,
    TorchConv,
    TorchConvTranspose,
    dtype_of,
    use_bias_for,
)
from nirgan_tpu_torch.ops.initializers import Init


class UnetSkipConnectionBlock(nn.Module):
    """One level: ``depth_below`` nested blocks under it, ``num_downs``
    levels in all (``nirgan_tpu/models/unet.py:21-64``)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None, outermost: bool = False,
                 innermost: bool = False, norm_type: str = "instance",
                 use_dropout: bool = False, depth_below: int = 0,
                 ngf: int = 64, num_downs: int = 8,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        middle = not (outermost or innermost)
        bias = True if outermost else use_bias_for(norm_type)
        cin = input_nc if input_nc is not None else outer_nc
        self.down = TorchConv(cin, inner_nc, 4, stride=2, padding=1,
                              use_bias=bias, device=device)
        self.downnorm = Norm(norm_type, inner_nc, device) if middle else None
        self.sub = (None if innermost else
                    _submodule(norm_type, use_dropout, depth_below, ngf,
                               num_downs, device))
        self.up = TorchConvTranspose(inner_nc if innermost else 2 * inner_nc,
                                     outer_nc, 4, stride=2, padding=1,
                                     output_padding=0, use_bias=bias,
                                     device=device)
        self.upnorm = None if outermost else Norm(norm_type, outer_nc, device)
        self.dropout = Dropout(0.5) if use_dropout and middle else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.outermost else F.leaky_relu(x, 0.2)
        h = self.down(h)
        if self.downnorm is not None:
            h = self.downnorm(h)
        if self.sub is not None:
            h = self.sub(h)
        h = self.up(torch.relu(h))
        if self.outermost:
            return torch.tanh(h)
        h = self.upnorm(h)
        if self.dropout is not None:
            h = self.dropout(h)
        return torch.cat([x, h], dim=-1)


def _submodule(norm_type: str, use_dropout: bool, depth_below: int, ngf: int,
               num_downs: int, device) -> UnetSkipConnectionBlock:
    """The next inner block (``nirgan_tpu/models/unet.py:67-93``): the
    innermost at 8 ngf, ``num_downs - 5`` middle blocks at 8 ngf (with the
    dropout), then the ramp at 4, 2 and 1 ngf."""
    d, n_mid = depth_below, num_downs - 5
    kw = dict(norm_type=norm_type, depth_below=d - 1, ngf=ngf,
              num_downs=num_downs, device=device)
    if d == 1:
        return UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, **kw)
    if d <= 1 + n_mid:
        return UnetSkipConnectionBlock(ngf * 8, ngf * 8, use_dropout=use_dropout,
                                       **kw)
    mult = 2 ** (3 - (d - 1 - n_mid))
    return UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2, **kw)


class UnetGenerator(nn.Module):
    """U-Net with ``num_downs`` stride-2 levels (unet_128: 7, unet_256: 8);
    an input's sides must divide by 2^num_downs.  Params are f32,
    ``compute_dtype`` is the activation dtype."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int,
                 ngf: int = 64, norm_type: str = "instance",
                 use_dropout: bool = False, compute_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if num_downs < 5:
            raise ValueError("num_downs must be >= 5")
        self.num_downs = num_downs
        self.norm_type = norm_type
        self.compute_dtype = dtype_of(compute_dtype)
        self.unet = UnetSkipConnectionBlock(
            output_nc, ngf, input_nc=input_nc, outermost=True,
            norm_type=norm_type, use_dropout=use_dropout,
            depth_below=num_downs - 1, ngf=ngf, num_downs=num_downs,
            device=device)

    def reset_parameters(self, generator: torch.Generator, init: Init) -> None:
        """Every conv weight from ``init`` (biases zero), every batch norm's
        scale from N(1, 0.02), in module order."""
        for m in self.modules():
            if isinstance(m, (TorchConv, TorchConvTranspose)):
                m.reset_parameters(init, generator)
            elif isinstance(m, Norm):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, embeds: Optional[torch.Tensor] = None,
                trunk_q: Optional[dict] = None) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC -> (B, H, W, output_nc) in
        ``compute_dtype``.  ``embeds`` is ignored, as in the JAX module (the
        U-Net has no injection route); the int8 trunk is a ResNet's."""
        if trunk_q is not None:
            raise ValueError("the int8 trunk serves ResNet generators only")
        side = 1 << self.num_downs
        if x.shape[1] % side or x.shape[2] % side:
            raise ValueError(f"a U-Net of {self.num_downs} levels needs H and W "
                             f"divisible by {side}, got {tuple(x.shape[1:3])}")
        return self.unet(x.to(self.compute_dtype))
