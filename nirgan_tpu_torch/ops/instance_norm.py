"""Kernels B and B4: affine-free instance norm, forward with an optional
fused ReLU and its backward (``csrc/instance_norm.cu``).

Replaces ``nirgan_tpu/ops/pallas_kernels.py``: ``instance_norm_pallas``,
its forward (``_fwd_kernel``, ``_moments``) and the backward of its custom
VJP (``_bwd_kernel``).  On an H100 both directions are bound by device
memory; blocks cannot carry sums across a grid the way the TPU's sequential
grid did, so each kernel reduces per-slab partial sums, adds them per
(image, channel) in a fixed order, then runs one elementwise pass.  The
backward takes mean and scale from the forward's statistics instead of
recomputing the moments.  The source's header has the design.

``instance_norm`` is one ``torch.autograd.Function``: a CUDA tensor launches
the kernels in both directions or raises, a CPU tensor takes the plain
versions, so the CPU runs the same graph wiring as the card.  It is the
entry the models call, the counterpart of ``nirgan_tpu/ops/norm.py``
(affine-free, stat-free everywhere, reference ``model/networks.py:30``).
"""

from __future__ import annotations

import torch

from nirgan_tpu_torch.ops import _lib

NAME = "instance_norm"
BWD_NAME = "instance_norm_bwd"
# partial-sum slabs per image: enough blocks in flight to cover the card's
# 132 SMs about twice at batch 4
_TARGET_BLOCKS = 264


def _stats(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, 2, C) f32: mean and 1 / sqrt(var + eps) over H, W."""
    mean = x32.mean(dim=(1, 2))
    var = x32.square().mean(dim=(1, 2)) - mean.square()
    return torch.stack([mean, torch.reciprocal(torch.sqrt(var + eps))], 1)


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False, return_stats: bool = False):
    """The JAX formula of ``nirgan_tpu/ops/norm.py`` exactly: f32 statistics
    with var = E[x^2] - E[x]^2 and no clamp, then
    ``(x - mean.to(dtype)) * rsqrt(var + eps).to(dtype)`` in x's dtype.
    ``torch.nn.InstanceNorm2d`` is not this formula.  With
    ``return_stats`` also the (B, 2, C) f32 mean and scale."""
    stats = _stats(x.float(), eps)
    mean = stats[:, 0, None, None, :]
    scale = stats[:, 1, None, None, :]
    y = (x - mean.to(x.dtype)) * scale.to(x.dtype)
    y = torch.relu(y) if relu else y
    return (y, stats) if return_stats else y


def instance_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                            stats: torch.Tensor,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """The backward of ``_bwd_kernel`` in f32: with y = (x - mean) * r,
    ``dx = r * (g - mean(g) - y * mean(g * y))``, g first masked by
    ``out > 0`` when ``out`` (the forward's output with the ReLU fused) is
    given; dx in x's dtype."""
    g32 = g.float()
    if out is not None:
        g32 = g32 * (out > 0)
    mean = stats[:, 0, None, None, :]
    r = stats[:, 1, None, None, :]
    y = (x.float() - mean) * r
    dx = r * (g32 - g32.mean(dim=(1, 2), keepdim=True)
              - y * (g32 * y).mean(dim=(1, 2), keepdim=True))
    return dx.to(x.dtype)


def _slabs(b: int, hw: int, c: int) -> int:
    groups = -(-c // 256)
    return max(1, min(hw, -(-_TARGET_BLOCKS // (b * groups))))


def _check(x: torch.Tensor, name: str) -> int:
    req = _lib.require
    req(x.is_cuda, name, "x must be a CUDA tensor")
    code = _lib.dtype_code(x, name)
    req(x.dim() == 4 and x.is_contiguous(), name,
        "x must be a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    req(c % 8 == 0, name, f"C = {c} must be a multiple of 8")
    req(h * w > 0 and b > 0, name, "empty input")
    return code


def instance_norm_cuda(x: torch.Tensor, eps: float = 1e-5,
                       relu: bool = False, return_stats: bool = False):
    """Launch kernel B on contiguous NHWC bf16 or f32; C must be a multiple
    of 8.  With ``return_stats`` also the (B, 2, C) f32 mean and scale."""
    code = _check(x, NAME)
    b, h, w, c = x.shape
    s = _slabs(b, h * w, c)
    part = torch.empty((b, s, 2, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    _lib.require(_lib.aligned(x, y), NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm(
        x.device.index, code, x.data_ptr(), part.data_ptr(), stats.data_ptr(),
        y.data_ptr(), b, h * w, c, s, float(eps), int(relu), _lib.stream_of(x))
    _lib.check(err, NAME)
    instance_norm_cuda.launches += 1
    return (y, stats) if return_stats else y


instance_norm_cuda.launches = 0


def instance_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                           stats: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel B4: the arguments of ``instance_norm_bwd_plain``, all
    contiguous NHWC in one dtype on the card, stats (B, 2, C) f32."""
    req = _lib.require
    code = _check(x, BWD_NAME)
    b, h, w, c = x.shape
    for name, t in (("g", g), ("out", out)):
        if t is not None:
            req(t.is_cuda and t.dtype == x.dtype and t.shape == x.shape
                and t.is_contiguous(), BWD_NAME,
                f"{name} must be a contiguous CUDA tensor like x")
    req(stats.dtype == torch.float32 and tuple(stats.shape) == (b, 2, c)
        and stats.is_contiguous() and stats.is_cuda, BWD_NAME,
        f"stats must be a contiguous ({b}, 2, {c}) f32 CUDA tensor")
    s = _slabs(b, h * w, c)
    part = torch.empty((b, s, 2, c), device=x.device, dtype=torch.float32)
    gstats = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    req(_lib.aligned(x, g, dx, *([out] if out is not None else [])),
        BWD_NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm_bwd(
        x.device.index, code, x.data_ptr(), g.data_ptr(),
        out.data_ptr() if out is not None else None, stats.data_ptr(),
        part.data_ptr(), gstats.data_ptr(), dx.data_ptr(), b, h * w, c, s,
        _lib.stream_of(x))
    _lib.check(err, BWD_NAME)
    instance_norm_bwd_cuda.launches += 1
    return dx


instance_norm_bwd_cuda.launches = 0


class InstanceNorm(torch.autograd.Function):
    """Forward kernel B, backward kernel B4 (the plain versions on the CPU).
    Saves x, the forward's f32 statistics and, with the ReLU fused, the
    output for its mask."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
        fwd = instance_norm_cuda if _lib.route(x, NAME) else instance_norm_plain
        y, stats = fwd(x, eps, relu, return_stats=True)
        ctx.relu = relu
        ctx.save_for_backward(x, stats, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, stats, out = ctx.saved_tensors
        g = g.contiguous()
        bwd = (instance_norm_bwd_cuda if _lib.route(x, BWD_NAME)
               else instance_norm_bwd_plain)
        return bwd(x, g, stats, out), None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """Differentiable per-sample, per-channel spatial normalisation of NHWC
    x (torch defaults: eps 1e-5, biased variance) with f32 statistics,
    normalised in x's dtype; ``relu=True`` applies ReLU to the result
    (exact, fused in the kernel)."""
    return InstanceNorm.apply(x, eps, relu)
