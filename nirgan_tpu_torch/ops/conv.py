"""Convolutions (NHWC activations, torch weight layouts), counterpart of
``nirgan_tpu/ops/conv.py``.

The forwards stay on PyTorch's own convolutions (cuDNN on a card): the JAX
package computes them in XLA, outside any Pallas kernel.  The stem, d0, d1,
u0 and u1 use them.  Weights are cast to the activation dtype, as the JAX
ops cast the kernel, and the bias is added after the convolution in that
dtype.  The reference's k3/s2/p1/op1 transposed convolution (u0, u1) is one
operator, ``torch.ops.nirgan.convt_k3s2``: its forward is PyTorch's
transposed convolution, its gradient the operator
``nirgan::convt_k3s2_bwd``, kernel B5 on a card (``ops/convt_bwd.py``, the
counterpart of ``_convt_core_k3s2_pallas``) and its plain version on the
CPU; the bias stays outside it, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from nirgan_tpu_torch.ops import _lib, _registry
from nirgan_tpu_torch.ops import convt_bwd as _convt_bwd


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


def _convt_k3s2(x, weight):
    """``nirgan::convt_k3s2``'s CPU and CUDA implementation: the k3/s2/p1/op1
    core without bias on NHWC x, on PyTorch's convolution."""
    return _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), stride=2,
                                    padding=1, output_padding=1))


def _fake(x, weight):
    _lib.route(x, _convt_bwd.NAME)
    b, h, w, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * w, weight.shape[1]))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


@once_differentiable
def _backward(ctx, g):
    """Kernel B5 on a card, its plain version on the CPU; the weight
    gradient comes back in f32, then in the weight's dtype."""
    x, weight = ctx.saved_tensors
    dx, dw = _convt_bwd.convt_k3s2_bwd(g.to(x.dtype).contiguous(), x.contiguous(),
                                       weight, ctx.needs_input_grad)
    return dx, dw.to(weight.dtype) if dw is not None else None


_registry.define("convt_k3s2(Tensor x, Tensor weight) -> Tensor", _convt_k3s2, _fake,
                 _backward, _setup)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 2,
                     padding: int = 1, output_padding: int = 1) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d``: x (B, H, W, Cin), weight
    (Cin, Cout, kh, kw).  The reference's k3 s2 p1 op1 gives an exact 2x
    upsample and runs through ``nirgan::convt_k3s2``."""
    if (tuple(weight.shape[2:]) == (3, 3) and stride == 2 and padding == 1
            and output_padding == 1):
        y = torch.ops.nirgan.convt_k3s2(x, weight)
    else:
        y = _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype),
                                     stride=stride, padding=padding,
                                     output_padding=output_padding))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
