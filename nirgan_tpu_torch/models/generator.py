"""ResNet encoder-decoder generator, counterpart of the plain
``ResnetGenerator`` of ``nirgan_tpu/models/generator.py:82-348``
(reference ``model/networks.py:316-434``).

c7s1-64, d128, d256, R256 x n, u128, u64, c7s1-out, tanh, on NHWC
activations.  The trunk convs run through kernel A (``ops/trunk_conv.py``,
reflect border inside the kernel), every instance norm through kernels B
and B4 (with the following ReLU fused), the head through kernel C
(``ops/head_conv.py``, bias and tanh fused), and the two transposed convs'
backward through kernel B5.  The stem, the two downsampling convs and the
transposed convs' forward stay on PyTorch's convolutions, as do the
backward of every conv but the transposed ones.  The TPU
layout variants of the JAX module (blocked stem, pad folds, the int8 trunk)
compute the same function and are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nirgan_tpu_torch.models.layers import (
    Norm,
    TorchConv,
    TorchConvTranspose,
    dtype_of,
    use_bias_for,
)
from nirgan_tpu_torch.ops.head_conv import head_conv
from nirgan_tpu_torch.ops.initializers import Init
from nirgan_tpu_torch.ops.pad import reflect_pad2d
from nirgan_tpu_torch.ops.trunk_conv import trunk_conv


def _check_supported(padding_type: str, use_dropout: bool) -> None:
    if padding_type != "reflect":
        raise NotImplementedError(
            f"padding [{padding_type}] is not ported yet (reflect only)")
    if use_dropout:
        raise NotImplementedError("generator dropout is not ported yet")


class ResnetBlock(nn.Module):
    """pad -> conv3 -> norm -> relu -> pad -> conv3 -> norm, plus identity
    skip (reference ``model/networks.py:377-434``); each pad + conv is one
    call of kernel A."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm_type: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True, device: Optional[torch.device] = None):
        super().__init__()
        _check_supported(padding_type, use_dropout)
        self.conv1 = TorchConv(dim, dim, 3, use_bias=use_bias, device=device)
        self.norm1 = Norm(norm_type)
        self.conv2 = TorchConv(dim, dim, 3, use_bias=use_bias, device=device)
        self.norm2 = Norm(norm_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = trunk_conv(x, self.conv1.weight, self.conv1.bias)
        h = self.norm1(h, relu=True)
        h = trunk_conv(h, self.conv2.weight, self.conv2.bias)
        return x + self.norm2(h)


class ResnetGenerator(nn.Module):
    """The plain generator (no SatCLIP injection).  Parameter names follow
    the JAX module: ``c0``, ``d0``, ``d1``, ``r{i}.conv1/conv2``, ``u0``,
    ``u1``, ``c1``.  Params are f32; ``compute_dtype`` is the activation
    dtype."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 norm_type: str = "instance", use_dropout: bool = False,
                 n_blocks: int = 9, padding_type: str = "reflect",
                 compute_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if n_blocks < 0:
            raise ValueError("n_blocks must be >= 0")
        _check_supported(padding_type, use_dropout)
        self.compute_dtype = dtype_of(compute_dtype)
        self.n_blocks = n_blocks
        bias = use_bias_for(norm_type)
        kw = dict(use_bias=bias, device=device)
        self.c0 = TorchConv(input_nc, ngf, 7, **kw)
        self.n0 = Norm(norm_type)
        self.d0 = TorchConv(ngf, ngf * 2, 3, stride=2, padding=1, **kw)
        self.nd0 = Norm(norm_type)
        self.d1 = TorchConv(ngf * 2, ngf * 4, 3, stride=2, padding=1, **kw)
        self.nd1 = Norm(norm_type)
        for i in range(n_blocks):
            self.add_module(f"r{i}", ResnetBlock(
                ngf * 4, padding_type, norm_type, use_dropout, bias, device))
        self.u0 = TorchConvTranspose(ngf * 4, ngf * 2, **kw)
        self.nu0 = Norm(norm_type)
        self.u1 = TorchConvTranspose(ngf * 2, ngf, **kw)
        self.nu1 = Norm(norm_type)
        # head bias is always on (networks.py:367)
        self.c1 = TorchConv(ngf, output_nc, 7, use_bias=True, device=device)

    def reset_parameters(self, generator: torch.Generator, init: Init) -> None:
        """Draw every conv weight from ``init`` (biases zero), in a fixed
        module order."""
        for m in self.modules():
            if isinstance(m, (TorchConv, TorchConvTranspose)):
                m.reset_parameters(init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC -> (B, H, W, output_nc) in
        ``compute_dtype``, values in [-1, 1]."""
        h = x.to(self.compute_dtype)
        h = self.n0(self.c0(reflect_pad2d(h, 3)), relu=True)
        h = self.nd0(self.d0(h), relu=True)
        h = self.nd1(self.d1(h), relu=True)
        for i in range(self.n_blocks):
            h = getattr(self, f"r{i}")(h)
        h = self.nu0(self.u0(h), relu=True)
        h = self.nu1(self.u1(h), relu=True)
        return head_conv(reflect_pad2d(h, 3), self.c1.weight, self.c1.bias)
