"""Kernel B: affine-free instance norm forward with an optional fused ReLU
(``csrc/instance_norm.cu``).

Replaces ``nirgan_tpu/ops/pallas_kernels.py``: ``instance_norm_pallas``
(forward, ``_fwd_kernel`` and ``_moments``).  On an H100 it is bound by
device memory (two reads and one write of the activation); blocks cannot
carry sums across a grid the way the TPU's sequential grid did, so the
kernel reduces per-slab partial sums, adds them per (image, channel) in a
fixed order, then normalises in one elementwise pass.  The source's header
has the design.

Dispatch: a CPU tensor takes ``instance_norm_plain``; a CUDA tensor launches
the kernel or raises.  ``nirgan_tpu_torch.ops.norm.instance_norm`` is the
entry the models call.
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.ops import _lib

NAME = "instance_norm"
# partial-sum slabs per image: enough blocks in flight to cover the card's
# 132 SMs about twice at batch 4
_TARGET_BLOCKS = 264


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    """The JAX formula of ``nirgan_tpu/ops/norm.py`` exactly: f32 statistics
    with var = E[x^2] - E[x]^2 and no clamp, then
    ``(x - mean.to(dtype)) * rsqrt(var + eps).to(dtype)`` in x's dtype.
    ``torch.nn.InstanceNorm2d`` is not this formula."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.square().mean(dim=(1, 2), keepdim=True) - mean.square()
    scale = torch.reciprocal(torch.sqrt(var + eps))
    y = (x - mean.to(x.dtype)) * scale.to(x.dtype)
    return torch.relu(y) if relu else y


def instance_norm_cuda(x: torch.Tensor, eps: float = 1e-5,
                       relu: bool = False) -> torch.Tensor:
    """Launch kernel B on contiguous NHWC bf16 or f32; C must divide 256
    and be a multiple of 8."""
    req = _lib.require
    req(x.is_cuda, NAME, "x must be a CUDA tensor")
    code = _lib.dtype_code(x, NAME)
    req(x.dim() == 4 and x.is_contiguous(), NAME,
        "x must be a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    req(c % 8 == 0 and 256 % c == 0, NAME,
        f"C = {c} must be a multiple of 8 that divides 256")
    req(h * w > 0 and b > 0, NAME, "empty input")
    s = max(1, min(h * w, -(-_TARGET_BLOCKS // b)))
    part = torch.empty((b, s, 2, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    req(_lib.aligned(x, y), NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm(
        x.device.index, code, x.data_ptr(), part.data_ptr(), stats.data_ptr(),
        y.data_ptr(), b, h * w, c, s, float(eps), int(relu), _lib.stream_of(x))
    _lib.check(err, NAME)
    instance_norm_cuda.launches += 1
    return y


instance_norm_cuda.launches = 0

