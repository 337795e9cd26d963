"""ResNet encoder-decoder generator, counterpart of ``ResnetGenerator`` of
``nirgan_tpu/models/generator.py:82-374`` (reference
``model/networks.py:316-434``), the SatCLIP injection variant included
(reference ``model/generator_inject.py:88-135``).

c7s1-64, d128, d256, R256 x n, u128, u64, c7s1-out, tanh, on NHWC
activations.  The trunk convs run through kernel A (``ops/trunk_conv.py``,
reflect border inside the kernel), every instance norm through kernels B
and B4 (with the following ReLU or a block's skip fused), the head through
kernel C (``ops/head_conv.py``, bias and tanh fused), and the two transposed convs'
backward through kernel B5.  The stem, the two downsampling convs and the
transposed convs' forward stay on PyTorch's convolutions, as do the
backward of every conv but the transposed ones.  With ``inject`` a 256-d
location embedding becomes a 128 x 128 plane (``fc``), is resized to the
feature map after ``nd0`` and combined with it *before* that norm's ReLU, so
there kernel B runs without its fused ReLU and a plain ReLU follows the
combination; the optional post-correction multiplies after kernel C's tanh.
The TPU
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
from nirgan_tpu_torch.ops.initializers import Init, normal
from nirgan_tpu_torch.ops.pad import reflect_pad2d
from nirgan_tpu_torch.ops.resize import resize_bilinear
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
    call of kernel A, and the skip is added inside the second norm's
    kernel."""

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
        return self.norm2(h, residual=x)


class ResnetGenerator(nn.Module):
    """c7s1-64, d128, d256, R256 x n, u128, u64, c7s1-out, tanh.  Parameter
    names follow the JAX module: ``c0``, ``d0``, ``d1``,
    ``r{i}.conv1/conv2``, ``u0``, ``u1``, ``c1``.  Params are f32;
    ``compute_dtype`` is the activation dtype.

    With ``inject=True`` this is the reference's ``ResnetGenerator_inject``:
    ``fc`` (embed_dim -> embed_plane^2, torch's (out, in) weight),
    ``scale_param`` and ``post_correction_param`` under the reference's
    state_dict names.  ``inject_style``: "add" (h + scale * plane, needs the
    scale) or "multiply" (h * (1 + scale * plane), or h * plane without
    ``scaling_param``)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 norm_type: str = "instance", use_dropout: bool = False,
                 n_blocks: int = 9, padding_type: str = "reflect",
                 compute_dtype=torch.float32,
                 device: Optional[torch.device] = None,
                 inject: bool = False, inject_style: str = "multiply",
                 scaling_param: bool = True, scaling_param_init: float = 0.01,
                 post_correction: bool = False,
                 post_correction_init: float = 1.0, embed_dim: int = 256,
                 embed_plane: int = 128):
        super().__init__()
        if n_blocks < 0:
            raise ValueError("n_blocks must be >= 0")
        _check_supported(padding_type, use_dropout)
        if inject and inject_style not in ("add", "multiply"):
            raise NotImplementedError(
                f"inject style [{inject_style}] is not implemented")
        if inject and inject_style == "add" and not scaling_param:
            raise ValueError("inject style [add] needs scaling_param")
        self.inject, self.inject_style = bool(inject), inject_style
        self.embed_plane = int(embed_plane)
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
        self.scale_param = self.post_correction_param = None
        if self.inject:
            self.fc = nn.Linear(embed_dim, embed_plane * embed_plane,
                                device=device)
            if scaling_param:
                self.scale_param = nn.Parameter(torch.full(
                    (), float(scaling_param_init), device=device))
            if post_correction:
                self.post_correction_param = nn.Parameter(torch.full(
                    (), float(post_correction_init), device=device))

    def reset_parameters(self, generator: torch.Generator, init: Init) -> None:
        """Draw every conv weight from ``init`` (biases zero), in a fixed
        module order; then ``fc`` from N(0, 0.02) with a zero bias, as the
        JAX module's dense layer, so the convs of the plain and the inject
        generator are the same from one seed."""
        for m in self.modules():
            if isinstance(m, (TorchConv, TorchConvTranspose)):
                m.reset_parameters(init, generator)
        if self.inject:
            normal(0.02)(self.fc.weight, generator)
            with torch.no_grad():
                self.fc.bias.zero_()

    def location_plane(self, embeds: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
        """(B, embed_dim) -> the (B, width, height, 1) plane for a feature
        map of (height, width): ``fc`` in the compute dtype, then the
        bilinear resize with the reference's swapped size=(W, H)
        (``generator_inject.py:116``), kept for parity."""
        e = embeds.to(self.compute_dtype)
        plane = e @ self.fc.weight.to(e.dtype).t() + self.fc.bias.to(e.dtype)
        plane = plane.reshape(-1, self.embed_plane, self.embed_plane, 1)
        return resize_bilinear(plane, width, height)

    def _inject(self, h: torch.Tensor, embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if embeds is None:
            raise ValueError("inject-style generator requires a location "
                             "embedding input")
        # broadcast over the channels; the swapped size fits square maps only
        plane = self.location_plane(embeds, h.shape[1], h.shape[2])
        if self.scale_param is None:
            return h * plane
        scaled = self.scale_param.to(h.dtype) * plane
        if self.inject_style == "add":
            return h + scaled
        return h * (1.0 + scaled)

    def forward(self, x: torch.Tensor,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC [, embeds (B, embed_dim)] ->
        (B, H, W, output_nc) in ``compute_dtype``; values in [-1, 1] before
        the post-correction."""
        h = x.to(self.compute_dtype)
        h = self.n0(self.c0(reflect_pad2d(h, 3)), relu=True)
        if self.inject:
            # the combination sits between nd0's norm and its ReLU
            h = torch.relu(self._inject(self.nd0(self.d0(h)), embeds))
        else:
            h = self.nd0(self.d0(h), relu=True)
        h = self.nd1(self.d1(h), relu=True)
        for i in range(self.n_blocks):
            h = getattr(self, f"r{i}")(h)
        h = self.nu0(self.u0(h), relu=True)
        h = self.nu1(self.u1(h), relu=True)
        h = head_conv(reflect_pad2d(h, 3), self.c1.weight, self.c1.bias)
        if self.post_correction_param is not None:
            h = h * self.post_correction_param.to(h.dtype)
        return h
