"""Kernel A: the residual trunk's 3x3 convolution with the reflect border
inside the kernel (``csrc/trunk_conv.cu``).

Replaces ``nirgan_tpu/ops/pallas_trunk.py``: ``conv3x3_reflect_pallas``
(``pad=1``: ``conv2d(reflect_pad2d(x, 1), w) + b``, no padded tensor) and
``conv3x3_pallas`` (``pad=0``: the VALID conv of an already padded input).
On an H100 the serving trunk conv is bound by the tensor cores (about 2300
FLOP per byte moved; 0.084 ms at their bf16 peak).  The kernel is an
implicit GEMM with f32 accumulation and the bias in the epilogue: wgmma on
the generator's trunk shape (bf16, Cin % 64 == 0, Cout == 256; the weights
go to it packed by ``_pack.pack_b128``), WMMA on other bf16 shapes and SIMT
f32 on float32.  The source's header has the design.

``trunk_conv`` is one ``torch.autograd.Function``.  Forward: a CPU tensor
takes ``trunk_conv_plain``; a CUDA tensor launches the kernel or raises.
Backward: PyTorch's own convolution gradients on the reflect-padded input,
then the adjoint of the pad (fixed-order adds, so a step's gradients repeat
bit for bit), as the JAX package trains the trunk through XLA's
convolutions (``pallas_trunk.py`` has no backward kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nirgan_tpu_torch.ops import _lib
from nirgan_tpu_torch.ops._pack import laid_out, pack_b128, taps_first
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad2d_adjoint

NAME = "trunk_conv"


def trunk_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     pad: int = 1) -> torch.Tensor:
    """``F.conv2d`` on the reflect-padded input.  x (B, H, W, Cin) NHWC,
    weight (Cout, Cin, 3, 3); returns NHWC in x's dtype."""
    xp = reflect_pad2d(x, pad) if pad else x
    y = F.conv2d(xp.permute(0, 3, 1, 2), weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def takes_wgmma(dtype: torch.dtype, ci: int, co: int) -> bool:
    """The shapes that go to the wgmma kernel, with packed weights.  The
    rule is written here only: ``nirgan_trunk_conv`` runs the kernel it is
    told to and refuses one that cannot take the shape."""
    return dtype == torch.bfloat16 and co == 256 and ci > 0 and ci % 64 == 0


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the wgmma kernel's B images: tap-major, then
    64-channel slices of Cin, each (Cout rows, 64) in the 128-byte swizzle."""
    co, ci = weight.shape[:2]
    return pack_b128(weight.permute(2, 3, 0, 1).reshape(9, co, ci))


def launch_plan(dtype: torch.dtype, x_shape: tuple, w_shape: tuple,
                pad: int) -> tuple[int, int, bool]:
    """(Ho, Wo, packed weights?) of a launch on x of ``x_shape`` (B, H, W,
    Cin) in ``dtype`` with a (Cout, Cin, 3, 3) weight; raises ValueError on
    what no kernel takes: bf16 needs Cin % 32 == 0 and Cout % 128 == 0, f32
    Cin % 16 == 0 and Cout % 64 == 0."""
    req = _lib.require
    req(dtype in (torch.float32, torch.bfloat16), NAME,
        f"dtype {dtype} not supported (float32, bfloat16)")
    req(len(x_shape) == 4, NAME, "x must be a (B, H, W, C) tensor")
    req(pad in (0, 1), NAME, f"pad must be 0 or 1, got {pad}")
    b, hi, wi, ci = x_shape
    co = w_shape[0]
    req(tuple(w_shape) == (co, ci, 3, 3), NAME,
        f"weight {tuple(w_shape)} is not (Cout, {ci}, 3, 3)")
    k_ci, k_co = (32, 128) if dtype == torch.bfloat16 else (16, 64)
    req(ci % k_ci == 0 and co % k_co == 0, NAME,
        f"channels {ci}->{co} need Cin % {k_ci} == 0 and Cout % {k_co} == 0")
    if pad:
        req(hi >= 2 and wi >= 2, NAME, "reflect padding needs H, W >= 2")
        ho, wo = hi, wi
    else:
        req(hi >= 3 and wi >= 3, NAME, "a VALID 3x3 conv needs H, W >= 3")
        ho, wo = hi - 2, wi - 2
    req(0 < b * hi * wi < 2 ** 31, NAME, "need 0 < B*H*W < 2^31")
    return ho, wo, takes_wgmma(dtype, ci, co)


def trunk_conv_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    pad: int = 1) -> torch.Tensor:
    """Launch kernel A on contiguous NHWC x on a CUDA device, at the shapes
    ``launch_plan`` takes."""
    req = _lib.require
    req(x.is_cuda, NAME, "x must be a CUDA tensor")
    code = _lib.dtype_code(x, NAME)
    req(x.dim() == 4 and x.is_contiguous(), NAME,
        "x must be a contiguous (B, H, W, C) tensor")
    ho, wo, packed = launch_plan(x.dtype, tuple(x.shape), tuple(weight.shape),
                                 pad)
    b, hi, wi, ci = x.shape
    co = weight.shape[0]
    w = laid_out(weight, x.device, x.dtype,
                 pack_weight if packed else taps_first)
    bf = None
    if bias is not None:
        req(tuple(bias.shape) == (co,), NAME, f"bias must be ({co},)")
        bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((b, ho, wo, co), device=x.device, dtype=x.dtype)
    req(_lib.aligned(x, w, y), NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_trunk_conv(
        x.device.index, code, x.data_ptr(), w.data_ptr(),
        bf.data_ptr() if bf is not None else None, y.data_ptr(),
        b, hi, wi, ci, ho, wo, co, pad, int(packed), _lib.stream_of(x))
    _lib.check(err, NAME)
    trunk_conv_cuda.launches += 1
    return y


trunk_conv_cuda.launches = 0


def trunk_conv_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                   pad: int, needs=(True, True, True)):
    """Gradients of ``trunk_conv`` for the NHWC cotangent g: (dx, dweight,
    dbias), each None where ``needs`` says so.  The weight gradient is
    taken in x's dtype, as the JAX convolution casts the weight, then
    returned in the weight's dtype; the bias gradient is an f32 sum."""
    xp = reflect_pad2d(x, pad) if pad else x
    gn = g.permute(0, 3, 1, 2)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        gn, xp.permute(0, 3, 1, 2), weight.to(x.dtype), None, [1, 1], [0, 0],
        [1, 1], False, [0, 0], 1, [needs[0], needs[1], False])
    dx = None
    if needs[0]:
        dx = reflect_pad2d_adjoint(dxp.permute(0, 2, 3, 1), pad).contiguous()
    dw = dw.to(weight.dtype) if needs[1] else None
    db = g.float().sum(dim=(0, 1, 2)) if needs[2] else None
    return dx, dw, db


class TrunkConv(torch.autograd.Function):
    """Forward kernel A (the plain version on the CPU), backward
    ``trunk_conv_bwd``."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad):
        fwd = trunk_conv_cuda if _lib.route(x, NAME) else trunk_conv_plain
        ctx.pad = pad
        ctx.save_for_backward(x, weight)
        return fwd(x, weight, bias, pad)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = trunk_conv_bwd(x, weight, g.contiguous(), ctx.pad,
                                    ctx.needs_input_grad[:3])
        return dx, dw, db, None


def trunk_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               pad: int = 1) -> torch.Tensor:
    """``conv2d(reflect_pad2d(x, pad), weight) + bias`` for a 3x3 stride-1
    conv on NHWC x (pad 0: VALID), differentiable in x, weight and bias."""
    return TrunkConv.apply(x, weight, bias, pad)
