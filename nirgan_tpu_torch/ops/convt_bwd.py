"""Kernel B5: the backward of the k3/s2/p1/op1 transposed convolution, the
input gradient and the weight gradient (``csrc/convt_bwd.cu``).

Replaces ``nirgan_tpu/ops/pallas_convt_bwd.py``: ``convt_k3s2_bwd``
(reached through ``_convt_core_k3s2_pallas`` in ``nirgan_tpu/ops/conv.py``).
On an H100 both gradients are bound by the tensor cores.  The TPU kernel's
one pass over the cotangent relied on a 295 KB dW accumulator resident in
VMEM across a sequential grid, which no Hopper block has; here dx is an
implicit GEMM over the stride-2 taps and dW a split-K GEMM whose f32
partials are added in a fixed order.  The source's header has the design.

Dispatch: ``ops/conv.py`` calls ``convt_k3s2_bwd_cuda`` for a CUDA tensor
(the kernel or an error) and ``convt_k3s2_bwd_plain`` for a CPU tensor.
Both take and return the JAX kernel's layout of activations (NHWC) and
torch's weight layout (Cin, Cout, 3, 3).
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.ops import _lib

NAME = "convt_bwd"
# split-K slabs of the weight gradient: about two blocks per SM of the 132
_TARGET_BLOCKS = 264
# output tile of the weight-gradient GEMM: (rows of Ci, columns of 9 * Co),
# bf16 (WMMA) and f32 (SIMT)
_DW_TILE = {1: (128, 128), 0: (64, 64)}


def convt_k3s2_bwd_plain(ct: torch.Tensor, z: torch.Tensor,
                         weight: torch.Tensor,
                         needs=(True, True)) -> tuple:
    """(dx, dW) of ``conv_transpose2d(z, weight, stride=2, padding=1,
    output_padding=1)`` for the NHWC cotangent ct, from PyTorch's own
    convolution gradients; dx in z's dtype, dW in f32, each None where
    ``needs`` says so."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        ct.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2), weight.to(z.dtype),
        None, [2, 2], [1, 1], [1, 1], True, [1, 1], 1,
        [needs[0], needs[1], False])
    dx = dx.permute(0, 2, 3, 1).contiguous() if needs[0] else None
    dw = dw.float() if needs[1] else None
    return dx, dw


def convt_k3s2_bwd_cuda(ct: torch.Tensor, z: torch.Tensor,
                        weight: torch.Tensor, needs=(True, True)) -> tuple:
    """Launch kernel B5: ct (B, 2H, 2W, Co) and z (B, H, W, Ci) contiguous
    NHWC in one dtype (bf16 or f32) on the card, weight (Ci, Co, 3, 3); Ci
    and Co multiples of 8.  Returns dx in z's dtype and dW in f32."""
    req = _lib.require
    req(ct.is_cuda and z.is_cuda, NAME, "ct and z must be CUDA tensors")
    code = _lib.dtype_code(ct, NAME)
    req(z.dtype == ct.dtype, NAME, f"z is {z.dtype}, ct {ct.dtype}")
    req(ct.dim() == 4 and z.dim() == 4 and ct.is_contiguous()
        and z.is_contiguous(), NAME, "ct and z must be contiguous NHWC")
    b, hi, wi, ci = z.shape
    co = ct.shape[3]
    req(tuple(ct.shape) == (b, 2 * hi, 2 * wi, co), NAME,
        f"ct {tuple(ct.shape)} is not (B, 2H, 2W, Co) of z {tuple(z.shape)}")
    req(tuple(weight.shape) == (ci, co, 3, 3), NAME,
        f"weight {tuple(weight.shape)} is not ({ci}, {co}, 3, 3)")
    req(ci % 8 == 0 and co % 8 == 0, NAME,
        f"channels {ci}, {co} must be multiples of 8")
    m = b * hi * wi
    req(0 < m < 2 ** 31, NAME, f"{m} input pixels: need 0 < B*H*W < 2^31")
    # (Ci, Co, ky, kx) -> (ky, kx, Co, Ci) in the compute dtype
    w = weight.to(device=ct.device, dtype=ct.dtype).permute(2, 3, 1, 0).contiguous()
    tm, tn = _DW_TILE[code]
    tiles = -(-ci // tm) * -(-9 * co // tn)
    s = max(1, min(m, -(-_TARGET_BLOCKS // tiles)))
    slab = -(-m // s)
    s = -(-m // slab)
    dx = torch.empty_like(z) if needs[0] else None
    dw = part = None
    if needs[1]:
        dw = torch.empty((ci, co, 3, 3), device=ct.device, dtype=torch.float32)
        part = torch.empty((s, ci, 9 * co), device=ct.device,
                           dtype=torch.float32)
    req(_lib.aligned(ct, z, w, *([dx] if dx is not None else [])), NAME,
        "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_convt_bwd(
        ct.device.index, code, ct.data_ptr(), z.data_ptr(), w.data_ptr(),
        dx.data_ptr() if dx is not None else None,
        part.data_ptr() if part is not None else None,
        dw.data_ptr() if dw is not None else None, b, hi, wi, ci, co, s, slab,
        int(bool(needs[0])), int(bool(needs[1])), _lib.stream_of(ct))
    _lib.check(err, NAME)
    convt_k3s2_bwd_cuda.launches += 1
    return dx, dw


convt_k3s2_bwd_cuda.launches = 0
