"""Kernel B5: the backward of the k3/s2/p1/op1 transposed convolution, the
input gradient and the weight gradient (``csrc/convt_bwd.cu``).

Replaces ``nirgan_tpu/ops/pallas_convt_bwd.py``: ``convt_k3s2_bwd``
(reached through ``_convt_core_k3s2_pallas`` in ``nirgan_tpu/ops/conv.py``).
On an H100 the tensor cores' bound (0.091 ms at u1) and the memory's (0.093
ms) meet.  The TPU kernel's one pass over the cotangent relied on a 295 KB
dW accumulator resident in VMEM across a sequential grid, which no Hopper
block has; here dx is an implicit GEMM over the stride-2 taps and dW a
split-K GEMM whose f32 partials are added in a fixed order, both on wgmma
at the generator's shapes (bf16, Ci 128 or 256, Co % 64 == 0; the weights
go to dx packed by ``_pack.pack_b128``), on WMMA or SIMT f32 otherwise.
The source's header has the design.

Dispatch: ``ops/conv.py`` calls ``convt_k3s2_bwd_cuda`` for a CUDA tensor
(the kernel or an error) and ``convt_k3s2_bwd_plain`` for a CPU tensor.
Both take and return the JAX kernel's layout of activations (NHWC) and
torch's weight layout (Cin, Cout, 3, 3).
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.ops import _lib
from nirgan_tpu_torch.ops._pack import laid_out, pack_b128, taps_first

NAME = "convt_bwd"
# split-K slabs of the weight gradient: about two blocks per SM of the 132
# for the WMMA and SIMT kernels, one for the wgmma kernel (a block fills an
# SM's shared memory)
_TARGET_BLOCKS = 264
_TARGET_BLOCKS_WGMMA = 132
# output tile of the weight-gradient GEMM: (rows of Ci, columns of 9 * Co),
# bf16 (WMMA) and f32 (SIMT)
_DW_TILE = {1: (128, 128), 0: (64, 64)}


def takes_wgmma(dtype: torch.dtype, ci: int, co: int) -> bool:
    """The shapes that go to the wgmma kernels, with packed weights.  The
    rule is written here only: ``nirgan_convt_bwd`` runs the kernels it is
    told to and refuses ones that cannot take the shape."""
    return dtype == torch.bfloat16 and ci in (128, 256) and co > 0 and co % 64 == 0


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, 3, 3) -> the wgmma dx kernel's B images: tap-major, then
    64-channel slices of Co, each (Ci rows, 64) in the 128-byte swizzle."""
    ci, co = weight.shape[:2]
    return pack_b128(weight.permute(2, 3, 0, 1).reshape(9, ci, co))


def dw_slabs(m: int, ci: int, co: int, wgmma: bool, code: int) -> tuple[int, int]:
    """(slabs, pixels a slab) of the weight gradient's split over the m
    pixels: enough blocks to fill the card, every slab non-empty; the wgmma
    kernel walks a slab in slices of 64 pixels, so its slabs are multiples
    of 64."""
    if wgmma:
        tiles = 3 * (co // 64) * (ci // 128)
        target = _TARGET_BLOCKS_WGMMA
    else:
        tm, tn = _DW_TILE[code]
        tiles = -(-ci // tm) * -(-9 * co // tn)
        target = _TARGET_BLOCKS
    s = max(1, min(m, target // tiles if wgmma else -(-target // tiles)))
    slab = -(-m // s)
    if wgmma:
        slab = -(-slab // 64) * 64
    return -(-m // slab), slab


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


def launch_plan(dtype: torch.dtype, z_shape: tuple, ct_shape: tuple,
                w_shape: tuple) -> tuple[bool, int, int]:
    """(packed weights?, slabs, pixels a slab) of a launch on z (B, H, W,
    Ci) and ct (B, 2H, 2W, Co) in ``dtype`` with a (Ci, Co, 3, 3) weight;
    raises ValueError on what no kernel takes (Ci and Co must be multiples
    of 8)."""
    req = _lib.require
    req(dtype in (torch.float32, torch.bfloat16), NAME,
        f"dtype {dtype} not supported (float32, bfloat16)")
    req(len(z_shape) == 4 and len(ct_shape) == 4, NAME,
        "ct and z must be (B, H, W, C) tensors")
    b, hi, wi, ci = z_shape
    co = ct_shape[3]
    req(tuple(ct_shape) == (b, 2 * hi, 2 * wi, co), NAME,
        f"ct {tuple(ct_shape)} is not (B, 2H, 2W, Co) of z {tuple(z_shape)}")
    req(tuple(w_shape) == (ci, co, 3, 3), NAME,
        f"weight {tuple(w_shape)} is not ({ci}, {co}, 3, 3)")
    req(ci % 8 == 0 and co % 8 == 0, NAME,
        f"channels {ci}, {co} must be multiples of 8")
    m = b * hi * wi
    req(0 < m < 2 ** 31, NAME, f"{m} input pixels: need 0 < B*H*W < 2^31")
    packed = takes_wgmma(dtype, ci, co)
    return (packed, *dw_slabs(m, ci, co, packed, int(dtype == torch.bfloat16)))


def convt_k3s2_bwd_cuda(ct: torch.Tensor, z: torch.Tensor,
                        weight: torch.Tensor, needs=(True, True)) -> tuple:
    """Launch kernel B5: ct (B, 2H, 2W, Co) and z (B, H, W, Ci) contiguous
    NHWC in one dtype (bf16 or f32) on the card, weight (Ci, Co, 3, 3), at
    the shapes ``launch_plan`` takes.  Returns dx in z's dtype and dW in
    f32."""
    req = _lib.require
    req(ct.is_cuda and z.is_cuda, NAME, "ct and z must be CUDA tensors")
    code = _lib.dtype_code(ct, NAME)
    req(z.dtype == ct.dtype, NAME, f"z is {z.dtype}, ct {ct.dtype}")
    req(ct.dim() == 4 and z.dim() == 4 and ct.is_contiguous()
        and z.is_contiguous(), NAME, "ct and z must be contiguous NHWC")
    packed, s, slab = launch_plan(ct.dtype, tuple(z.shape), tuple(ct.shape),
                                  tuple(weight.shape))
    b, hi, wi, ci = z.shape
    co = ct.shape[3]
    w = laid_out(weight, ct.device, ct.dtype,
                 pack_weight if packed else taps_first)
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
        int(bool(needs[0])), int(bool(needs[1])), int(packed),
        _lib.stream_of(ct))
    _lib.check(err, NAME)
    convt_k3s2_bwd_cuda.launches += 1
    return dx, dw


convt_k3s2_bwd_cuda.launches = 0
