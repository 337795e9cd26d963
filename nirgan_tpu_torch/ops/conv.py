"""Convolutions (NHWC activations, torch weight layouts), counterpart of
``nirgan_tpu/ops/conv.py``.

These stay on PyTorch's own convolutions (cuDNN on a card): the JAX package
computes them in XLA, outside any Pallas kernel.  The stem, d0, d1, u0 and
u1 use them.  Weights are cast to the activation dtype, as the JAX ops cast
the kernel, and the bias is added after the convolution in that dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """torch ``nn.Conv2d``: x (B, H, W, Cin), weight (Cout, Cin, kh, kw)."""
    y = F.conv2d(_nchw(x), weight.to(x.dtype), stride=stride, padding=padding)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return _nhwc(y)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 2,
                     padding: int = 1, output_padding: int = 1) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d``: x (B, H, W, Cin), weight
    (Cin, Cout, kh, kw).  The reference's k3 s2 p1 op1 gives an exact 2x
    upsample."""
    y = F.conv_transpose2d(_nchw(x), weight.to(x.dtype), stride=stride,
                           padding=padding, output_padding=output_padding)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return _nhwc(y)
