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
``UnetGenerator.forward_rows`` serves one shard of a tile sharded along H
over processes (``parallel/spatial.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nirgan_tpu_torch.models.generator import _norm_rows
from nirgan_tpu_torch.models.layers import (
    Dropout,
    Norm,
    TorchConv,
    TorchConvTranspose,
    dtype_of,
    use_bias_for,
)
from nirgan_tpu_torch.ops.conv import conv2d
from nirgan_tpu_torch.ops.initializers import Init
from nirgan_tpu_torch.parallel.spatial import unet_depth


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

    def forward_rows(self, x: torch.Tensor, shard, level: int, k: int) -> torch.Tensor:
        """``forward`` in serving mode on one shard's rows of the level-
        ``level`` map x (the tile halved ``level`` times), for a tile
        sharded down to level ``k`` (``UnetGenerator.forward_rows``).  Above
        level k the down conv runs VALID at stride 2 on the shard's slab
        (``shard.down4_slab``), the transposed conv on a slab one row
        deeper each way, cropped to the shard's rows (``shard.up4_slab``),
        each norm with the tile's pixel count at its level.  At level k the
        map is gathered whole (``shard.whole``) and this block runs
        ``forward`` on it, as every shard does alike; the shard keeps its
        own rows of the result."""
        if level == k:
            return self(shard.whole(x, level))[:, shard.lo >> level:shard.hi >> level]
        h = x if self.outermost else F.leaky_relu(x, 0.2)
        h = conv2d(shard.down4_slab(h), self.down.weight, self.down.bias, stride=2)
        if self.downnorm is not None:
            rows = shard.total_rows >> (level + 1)
            h = _norm_rows(self.downnorm, h, shard, rows * h.shape[2])
        if self.sub is not None:
            h = self.sub.forward_rows(h, shard, level + 1, k)
        t = h.shape[1]
        h = self.up(shard.up4_slab(torch.relu(h)))[:, 2:2 * t + 2]
        if self.outermost:
            return torch.tanh(h)
        h = _norm_rows(self.upnorm, h, shard, (shard.total_rows >> level) * h.shape[2])
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
        self._check(x.shape[1], x.shape[2], trunk_q)
        return self.unet(x.to(self.compute_dtype))

    def _check(self, h: int, w: int, trunk_q: Optional[dict]) -> None:
        if trunk_q is not None:
            raise ValueError("the int8 trunk serves ResNet generators only")
        side = 1 << self.num_downs
        if h % side or w % side:
            raise ValueError(f"a U-Net of {self.num_downs} levels needs H and W "
                             f"divisible by {side}, got {(h, w)}")

    @torch.no_grad()
    def forward_rows(self, x: torch.Tensor, shard,
                     trunk_q: Optional[dict] = None) -> torch.Tensor:
        """``forward`` in serving mode on one shard of an H-sharded tile
        (``parallel/spatial.Shard``): x (B, hi - lo, W, input_nc) holds the
        shard's rows [lo, hi) of the network input, and the result the same
        rows of the output.  The counterpart of GSPMD's partition of the
        JAX forward.  The tile stays sharded down to level k, the deepest
        at which every shard holds a row (``parallel/spatial.unet_depth``;
        ``shard_ranges`` puts every boundary on a multiple of 2^k rows).
        Down to there each k4 s2 p1 conv and transposed conv
        runs on the shard's slab (one halo row each side, from the
        neighbours by one ``all_gather``) on PyTorch's convolutions, and
        each instance norm is B's split forward with the tile's statistics
        (``shard.norm``); the batch norm in eval mode and no norm are
        pixelwise.  The level-k map is gathered whole to every shard (one
        ``all_gather``), and every shard recomputes the blocks from level k
        down, ``forward`` on the whole level-k map (1 / 4^k of the tile's
        pixels), with kernel B's one call a norm: at 2048^2 with unet_256
        over 2 shards k = 8 and nothing is gathered; at 512^2 over 4 k = 7,
        the innermost block on a 4^2 x 512 map; at 128^2 with unet_128 over
        4 k = 5, the two deepest blocks on a 4^2 x 512 map.  Raises
        ValueError, before any collective, where ``forward`` would.

        A sibling of ``forward``, not a path through it, as
        ``ResnetGenerator.forward_rows``: on a one-shard ``Shard`` it would
        copy every map into a slab and split every norm into two launches.
        A change to one is made to the other, and
        ``tests/test_torch_spatial.py`` (``test_world_of_one_matches_forward``)
        holds them equal."""
        self._check(shard.total_rows, x.shape[2], trunk_q)
        k = unet_depth(shard.total_rows, shard.n, self.num_downs)
        return self.unet.forward_rows(x.to(self.compute_dtype), shard, 0, k)
