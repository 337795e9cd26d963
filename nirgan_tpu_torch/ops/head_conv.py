"""Kernel C: the generator head, a valid 7x7 conv 64 -> 1 on the
reflect-padded input with bias and tanh in the epilogue
(``csrc/head_conv.cu``).

Replaces ``nirgan_tpu/ops/pallas_head.py``: ``head_conv_pallas``.  The TPU
kernel's factor-8 space-to-depth grid existed to fill the MXU's lanes; with
one output channel an H100 runs this in f32 FMA, bound by the SMs'
arithmetic and shared-memory bandwidth, so the kernel keeps the weights and
an input halo tile in shared memory and computes two outputs a thread.  The
source's header has the design.

``head_conv`` is one ``torch.autograd.Function``.  Forward: a CPU tensor
takes ``head_conv_plain``; a CUDA tensor launches the kernel or raises.
Backward: as ``pallas_head.py``'s custom VJP, tanh' = 1 - y^2 on the saved
output, then PyTorch's own convolution gradients for dx and the weight, and
a sum for the bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nirgan_tpu_torch.ops import _lib

NAME = "head_conv"
CIN = 64
K = 7


def head_conv_plain(x_padded: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tanh(conv2d(x_padded, weight) + bias)``: x_padded (B, H+6, W+6, C)
    NHWC, weight (1, C, 7, 7); returns (B, H, W, 1) in x's dtype."""
    y = F.conv2d(x_padded.permute(0, 3, 1, 2), weight.to(x_padded.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return torch.tanh(y).permute(0, 2, 3, 1).contiguous()


def head_conv_cuda(x_padded: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch kernel C on contiguous NHWC bf16 or f32 with 64 channels."""
    req = _lib.require
    x = x_padded
    req(x.is_cuda, NAME, "x must be a CUDA tensor")
    code = _lib.dtype_code(x, NAME)
    req(x.dim() == 4 and x.is_contiguous(), NAME,
        "x must be a contiguous (B, H, W, C) tensor")
    b, hp, wp, c = x.shape
    req(c == CIN, NAME, f"the kernel takes Cin = {CIN}, got {c}")
    req(tuple(weight.shape) == (1, CIN, K, K), NAME,
        f"weight {tuple(weight.shape)} is not (1, {CIN}, {K}, {K})")
    req(hp >= K and wp >= K, NAME, "input smaller than the 7x7 window")
    # (1, C, ky, kx) -> (ky, kx, C) f32, rounded to the compute dtype first
    # as the conv would use it
    w = (weight.to(device=x.device, dtype=x.dtype).float()[0]
         .permute(1, 2, 0).contiguous())
    bf = None
    if bias is not None:
        req(bias.numel() == 1, NAME, "bias must have one element")
        bf = bias.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    y = torch.empty((b, hp - K + 1, wp - K + 1, 1), device=x.device,
                    dtype=x.dtype)
    req(_lib.aligned(x, w), NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_head_conv(
        x.device.index, code, x.data_ptr(), w.data_ptr(),
        bf.data_ptr() if bf is not None else None, y.data_ptr(), b, hp, wp,
        _lib.stream_of(x))
    _lib.check(err, NAME)
    head_conv_cuda.launches += 1
    return y


head_conv_cuda.launches = 0


def head_conv_bwd(x_padded: torch.Tensor, weight: torch.Tensor,
                  y: torch.Tensor, g: torch.Tensor, needs=(True, True, True)):
    """Gradients of ``head_conv`` from its output y and the NHWC cotangent
    g: (dx, dweight, dbias), each None where ``needs`` says so."""
    gz = (g.float() * (1.0 - y.float().square())).to(x_padded.dtype)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gz.permute(0, 3, 1, 2), x_padded.permute(0, 3, 1, 2),
        weight.to(x_padded.dtype), None, [1, 1], [0, 0], [1, 1], False,
        [0, 0], 1, [needs[0], needs[1], False])
    dx = dx.permute(0, 2, 3, 1).contiguous() if needs[0] else None
    dw = dw.to(weight.dtype) if needs[1] else None
    db = gz.float().sum().reshape(1) if needs[2] else None
    return dx, dw, db


class HeadConv(torch.autograd.Function):
    """Forward kernel C (the plain version on the CPU), backward
    ``head_conv_bwd``."""

    @staticmethod
    def forward(ctx, x_padded, weight, bias):
        fwd = head_conv_cuda if _lib.route(x_padded, NAME) else head_conv_plain
        y = fwd(x_padded, weight, bias)
        ctx.save_for_backward(x_padded, weight, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x_padded, weight, y = ctx.saved_tensors
        return head_conv_bwd(x_padded, weight, y, g, ctx.needs_input_grad)


def head_conv(x_padded: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tanh(conv2d(x_padded, weight) + bias)`` for the 7x7 one-channel
    head on an NHWC input that is already reflect-padded by 3,
    differentiable in all three."""
    return HeadConv.apply(x_padded, weight, bias)
