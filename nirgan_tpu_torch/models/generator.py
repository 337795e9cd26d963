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
At widths a kernel is not built for (an ``ngf`` under 32 in bf16, any head
but 64 -> 1), the trunk convs and the head take their ops' library routes
(``trunk_conv_library``, ``head_conv_library``), chosen by shape.  With an
int8 pack (``forward(..., trunk_q=)``, serving only) the residual blocks run
as ``ops/int8_trunk.int8_trunk_forward``, on kernels D and E, with the
trunk's own border; a pack with ``"d1"`` (stage 2) also runs d1, its norm
and ReLU as ``int8_d1_forward``.  The TPU
layout variants of the JAX module (blocked stem, pad folds) compute the same
function and are not carried over.

The trunk's ``padding_type`` other than reflect (replicate, zero) pads
first (``ops/pad.py``; the replicate pad's adjoint adds in a fixed order)
and runs kernel A in its VALID mode (``pad=0``, the port of
``conv3x3_pallas``).  With ``use_dropout`` each block drops out after its
first norm's ReLU (which stays fused in kernel B).  ``norm_type`` "batch"
and "none" run those norms on PyTorch's ops (``models/layers.Norm``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nirgan_tpu_torch.models.layers import (
    Dropout,
    Norm,
    TorchConv,
    TorchConvTranspose,
    dtype_of,
    use_bias_for,
)
from nirgan_tpu_torch.ops.conv import conv2d
from nirgan_tpu_torch.ops.head_conv import head_conv
from nirgan_tpu_torch.ops.initializers import Init, normal
from nirgan_tpu_torch.ops.int8_trunk import int8_d1_forward, int8_trunk_forward
from nirgan_tpu_torch.ops.pad import reflect_pad2d, replicate_pad2d, zero_pad2d
from nirgan_tpu_torch.ops.resize import resize_bilinear
from nirgan_tpu_torch.ops.trunk_conv import trunk_conv


class ResnetBlock(nn.Module):
    """pad -> conv3 -> norm -> relu (-> dropout) -> pad -> conv3 -> norm,
    plus identity skip (reference ``model/networks.py:377-434``).  With
    reflect padding each pad + conv is one call of kernel A; with replicate
    or zero padding the pad comes first and kernel A runs VALID.  The skip
    is added inside the second norm's kernel."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm_type: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True, device: Optional[torch.device] = None):
        super().__init__()
        if padding_type not in ("reflect", "replicate", "zero"):
            raise NotImplementedError(
                f"padding [{padding_type}] is not implemented")
        self.padding_type = padding_type
        self.conv1 = TorchConv(dim, dim, 3, use_bias=use_bias, device=device)
        self.norm1 = Norm(norm_type, dim, device)
        self.dropout = Dropout(0.5) if use_dropout else None
        self.conv2 = TorchConv(dim, dim, 3, use_bias=use_bias, device=device)
        self.norm2 = Norm(norm_type, dim, device)

    def _conv(self, x: torch.Tensor, conv: TorchConv) -> torch.Tensor:
        if self.padding_type == "reflect":
            return trunk_conv(x, conv.weight, conv.bias)
        pad = replicate_pad2d if self.padding_type == "replicate" else zero_pad2d
        return trunk_conv(pad(x, 1), conv.weight, conv.bias, pad=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self._conv(x, self.conv1), relu=True)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.norm2(self._conv(h, self.conv2), residual=x)

    def forward_rows(self, x: torch.Tensor, shard, count: int) -> torch.Tensor:
        """``forward`` on one shard's rows of an H-sharded tile (serving):
        each conv is kernel A's VALID mode on the shard's slab (one halo row
        each side, the trunk's border at the tile's edges and columns), each
        norm the tile's (``count`` pixels)."""
        def conv(v, c):
            return trunk_conv(shard.slab(v, 1, 1, self.padding_type, 1), c.weight, c.bias,
                              pad=0)

        h = _norm_rows(self.norm1, conv(x, self.conv1), shard, count, relu=True)
        if self.dropout is not None:
            h = self.dropout(h)
        return _norm_rows(self.norm2, conv(h, self.conv2), shard, count, residual=x)


def _norm_rows(norm: Norm, x: torch.Tensor, shard, count: int, relu: bool = False,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``norm`` of an H-sharded tile at one shard's rows: the instance norm
    split across the shards (``shard.norm``, ``count`` pixels); the batch
    norm in eval mode and no norm are pixelwise."""
    if norm.norm_type == "instance":
        return shard.norm(x, count, relu, residual)
    return norm(x, relu=relu, residual=residual)


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
        if inject and inject_style not in ("add", "multiply"):
            raise NotImplementedError(
                f"inject style [{inject_style}] is not implemented")
        if inject and inject_style == "add" and not scaling_param:
            raise ValueError("inject style [add] needs scaling_param")
        self.inject, self.inject_style = bool(inject), inject_style
        self.embed_plane = int(embed_plane)
        self.compute_dtype = dtype_of(compute_dtype)
        self.n_blocks = n_blocks
        self.norm_type = norm_type
        self.padding_type = padding_type
        bias = use_bias_for(norm_type)
        kw = dict(use_bias=bias, device=device)
        self.c0 = TorchConv(input_nc, ngf, 7, **kw)
        self.n0 = Norm(norm_type, ngf, device)
        self.d0 = TorchConv(ngf, ngf * 2, 3, stride=2, padding=1, **kw)
        self.nd0 = Norm(norm_type, ngf * 2, device)
        self.d1 = TorchConv(ngf * 2, ngf * 4, 3, stride=2, padding=1, **kw)
        self.nd1 = Norm(norm_type, ngf * 4, device)
        for i in range(n_blocks):
            self.add_module(f"r{i}", ResnetBlock(
                ngf * 4, padding_type, norm_type, use_dropout, bias, device))
        self.u0 = TorchConvTranspose(ngf * 4, ngf * 2, **kw)
        self.nu0 = Norm(norm_type, ngf * 2, device)
        self.u1 = TorchConvTranspose(ngf * 2, ngf, **kw)
        self.nu1 = Norm(norm_type, ngf, device)
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
        """Draw every conv weight from ``init`` (biases zero) and every batch
        norm's scale from N(1, 0.02), in a fixed module order; then ``fc``
        from N(0, 0.02) with a zero bias, as the JAX module's dense layer,
        so the convs of the plain and the inject generator are the same from
        one seed."""
        for m in self.modules():
            if isinstance(m, (TorchConv, TorchConvTranspose)):
                m.reset_parameters(init, generator)
            elif isinstance(m, Norm):
                m.reset_parameters(generator)
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

    def forward(self, x: torch.Tensor, embeds: Optional[torch.Tensor] = None,
                trunk_q: Optional[dict] = None) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC [, embeds (B, embed_dim)] ->
        (B, H, W, output_nc) in ``compute_dtype``; values in [-1, 1] before
        the post-correction.  ``trunk_q``, a pack of
        ``ops/int8_trunk.quantize_trunk``, runs the residual trunk in int8
        (and d1 where it holds ``"d1"``): serving only, so it raises under
        autograd, and only with the affine-free instance norm the pack's
        arithmetic assumes."""
        if trunk_q is not None and (torch.is_grad_enabled()
                                    or self.norm_type != "instance"):
            raise ValueError("int8 trunk is a serving-only path and requires "
                             "affine-free InstanceNorm (norm_type='instance')")
        h = x.to(self.compute_dtype)
        h = self.n0(self.c0(reflect_pad2d(h, 3)), relu=True)
        if self.inject:
            # the combination sits between nd0's norm and its ReLU
            h = torch.relu(self._inject(self.nd0(self.d0(h)), embeds))
        else:
            h = self.nd0(self.d0(h), relu=True)
        h8 = None
        if trunk_q is not None and "d1" in trunk_q:
            # stage 2: d1 + nd1 + ReLU in int8, ending in the trunk's first
            # quantised input
            h, h8 = int8_d1_forward(h, trunk_q["d1"], trunk_q["s_in"][0],
                                    self.compute_dtype)
        else:
            h = self.nd1(self.d1(h), relu=True)
        if trunk_q is not None:
            h = int8_trunk_forward(h, trunk_q, self.padding_type, h8)
        for i in range(self.n_blocks if trunk_q is None else 0):
            h = getattr(self, f"r{i}")(h)
        h = self.nu0(self.u0(h), relu=True)
        h = self.nu1(self.u1(h), relu=True)
        h = head_conv(reflect_pad2d(h, 3), self.c1.weight, self.c1.bias)
        if self.post_correction_param is not None:
            h = h * self.post_correction_param.to(h.dtype)
        return h

    @torch.no_grad()
    def forward_rows(self, x: torch.Tensor, shard,
                     trunk_q: Optional[dict] = None) -> torch.Tensor:
        """``forward`` in serving mode on one shard of an H-sharded tile
        (``parallel/spatial.Shard``): x (B, hi - lo, W, input_nc) holds the
        shard's rows [lo, hi) of the network input, and the result the
        shard's rows of the output, (B, 4 t, W', output_nc) with t its trunk
        rows.  The counterpart of GSPMD's partition of the JAX forward: each
        layer runs on the shard's slab (``shard.slab``: the neighbours' halo
        rows, the border at the tile's edges, the border's columns), each
        convolution without a border of its own (the stem, d0 and d1 on
        cuDNN, the trunk on kernel A's VALID mode, the int8 trunk and stage
        2 on kernel D's VALID gathers, the head on kernel C, the transposed
        convs as in ``forward`` on a slab one row deeper), and each instance
        norm with the tile's statistics (``shard.norm``; kernel E with the
        tile's moments and pixel count).  The inject route raises as
        ``forward`` does without embeddings.

        A sibling of ``forward``, not a path through it: ``forward`` on a
        one-shard ``Shard`` would copy every map into a slab before each
        border (kernels A, C and D gather the border in place) and split
        every norm into two launches (kernel B takes the whole map in one),
        a cost the one-process serving path has no reason to pay.  So the
        layer sequence is written twice; a change to one is made to the
        other, and ``tests/test_torch_spatial.py``
        (``test_world_of_one_matches_forward``) holds them equal."""
        if trunk_q is not None and self.norm_type != "instance":
            raise ValueError("int8 trunk is a serving-only path and requires "
                             "affine-free InstanceNorm (norm_type='instance')")
        # the tile's rows at each resolution: two k3 s2 p1 halvings, rounded up
        n1 = (shard.total_rows + 1) // 2
        n2 = (n1 + 1) // 2
        h = x.to(self.compute_dtype)
        h = self.c0(shard.slab(h, 3, 3, "reflect", 3))
        h = _norm_rows(self.n0, h, shard, shard.total_rows * h.shape[2], relu=True)
        h = conv2d(shard.down_slab(h), self.d0.weight, self.d0.bias, stride=2)
        if self.inject:
            self._inject(h, None)  # raises: no embeddings reach a shard
        h = _norm_rows(self.nd0, h, shard, n1 * h.shape[2], relu=True)
        h8 = None
        if trunk_q is not None and "d1" in trunk_q:
            h, h8 = int8_d1_forward(h, trunk_q["d1"], trunk_q["s_in"][0],
                                    self.compute_dtype, shard, n2 * ((h.shape[2] - 1) // 2 + 1))
        else:
            h = conv2d(shard.down_slab(h), self.d1.weight, self.d1.bias, stride=2)
            h = _norm_rows(self.nd1, h, shard, n2 * h.shape[2], relu=True)
        trunk = n2 * h.shape[2]
        if trunk_q is not None:
            h = int8_trunk_forward(h, trunk_q, self.padding_type, h8, shard, trunk)
        for i in range(self.n_blocks if trunk_q is None else 0):
            h = getattr(self, f"r{i}").forward_rows(h, shard, trunk)
        for up, norm, rows in ((self.u0, self.nu0, 2 * n2), (self.u1, self.nu1, 4 * n2)):
            t = h.shape[1]
            h = up(shard.up_slab(h))[:, :2 * t]
            h = _norm_rows(norm, h, shard, rows * h.shape[2], relu=True)
        return head_conv(shard.slab(h, 3, 3, "reflect", 3), self.c1.weight, self.c1.bias)
