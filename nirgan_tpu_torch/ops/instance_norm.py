"""Kernels B and B4: affine-free instance norm, forward with an optional
fused ReLU and an optional fused skip, and its backward
(``csrc/instance_norm.cu``).

Replaces ``nirgan_tpu/ops/pallas_kernels.py``: ``instance_norm_pallas``,
its forward (``_fwd_kernel``, ``_moments``) and the backward of its custom
VJP (``_bwd_kernel``).  On an H100 both directions are bound by device
memory: the function needs the activation in once and out once.  Where a
cluster of up to eight blocks can hold one (image, channel group) slab in
shared memory, one launch reads it once, adds the statistics across the
cluster in a fixed order and normalises out of shared memory (the resident
regime, as the TPU kernel did in VMEM); where none can, a sums kernel and an
elementwise kernel stream it (two launches).  ``launch_plan`` chooses by
shape alone.  The backward takes mean and scale from the forward's
statistics, and the fused ReLU's mask from x with the forward's own
roundings, so the forward's output is never saved.  The source's header has
the design.

``instance_norm`` is one ``torch.autograd.Function``: a CUDA tensor launches
the kernels in both directions or raises, a CPU tensor takes the plain
versions, so the CPU runs the same graph wiring as the card.  It is the
entry the models call, the counterpart of ``nirgan_tpu/ops/norm.py``
(affine-free, stat-free everywhere, reference ``model/networks.py:30``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nirgan_tpu_torch.ops import _lib

NAME = "instance_norm"
BWD_NAME = "instance_norm_bwd"
# what a block may use of an SM's shared memory
MAX_SMEM = 232448
# the resident kernel's scratch ahead of its slab (SCRATCH_BYTES in the
# source) and its cp.async groups in flight a thread (STAGES)
_SCRATCH = 4608
_STAGES = 4
# blocks of at most this much fit three, or two, to an SM (228 KB, of which
# each block has 1 KB reserved)
_THIRD_SM = 76800
_HALF_SM = 114688
# the resident kernel's channel group (GROUP in the source): rows of 64 bytes
# in bf16.  Groups of 64 channels measured no faster at any main-path shape
# and leave fewer, larger blocks
_GROUP = 32
# streaming: blocks to fill 132 SMs with eight blocks of 256 threads each,
# and the most partial sums an elementwise block adds up again
_STREAM_BLOCKS = 132 * 8
_MAX_SLABS = 128


class Plan(NamedTuple):
    """How one call runs.  ``regime``: "resident" (one launch; a cluster of
    ``cluster`` blocks holds the slab of one image and ``group`` channels in
    shared memory) or "streaming" (two launches over ``slabs`` pixel ranges
    an image).  ``smem_bytes`` is a block's dynamic shared memory,
    ``stages`` the asynchronous copy groups a thread keeps in flight."""
    regime: str
    group: int
    cluster: int
    threads: int
    stages: int
    smem_bytes: int
    slabs: int

    @property
    def cuda_launches(self) -> int:
        return 1 if self.regime == "resident" else 2


def resident_plans(hw: int, c: int, itemsize: int,
                   backward: bool) -> list[Plan]:
    """Every resident plan that the kernel takes for hw pixels of c
    channels: clusters of 1, 2, 4, 8 whose blocks' slabs (x, and the
    cotangent too in the backward) fit in shared memory, smallest cluster
    first, with 512 threads where a block has its SM to itself."""
    if c % _GROUP:
        return []
    per_pixel = _GROUP * itemsize * (2 if backward else 1)
    plans = []
    for k in (1, 2, 4, 8):
        smem = _SCRATCH + -(-hw // k) * per_pixel
        if smem <= MAX_SMEM and k <= hw:
            plans.append(Plan("resident", _GROUP, k,
                              256 if smem <= _HALF_SM else 512, _STAGES, smem, k))
    return plans


def streaming_plan(b: int, hw: int, c: int, itemsize: int) -> Plan:
    """The streaming plan, for any C that is a multiple of 8: channel groups
    of up to 32 16-byte vectors, and pixel slabs enough to fill the card."""
    group = min(c, 32 * (16 // itemsize))
    groups = -(-c // group)
    slabs = max(1, min(hw, _MAX_SLABS, -(-_STREAM_BLOCKS // (b * groups))))
    slabs = -(-hw // -(-hw // slabs))  # no empty slab
    return Plan("streaming", group, 1, 256, 0, 0, slabs)


def launch_plan(b: int, hw: int, c: int, itemsize: int,
                backward: bool) -> Plan:
    """The plan for (b, hw, c) activations of ``itemsize`` bytes, by shape
    alone.  Resident, in channel groups of 32, where a cluster of up to 8
    blocks holds the slab: the smallest cluster whose blocks fit three to an
    SM, else two, else the smallest that fits at all (small blocks overlap
    one another's loads, cluster barrier and stores; tiny ones only pay for
    the barrier).  Else streaming."""
    if min(b, hw, c) <= 0 or c % 8:
        raise ValueError(f"{NAME}: no plan for b {b}, hw {hw}, c {c}")
    plans = resident_plans(hw, c, itemsize, backward)
    for limit in (_THIRD_SM, _HALF_SM, MAX_SMEM):
        for plan in plans:
            if plan.smem_bytes <= limit:
                return plan
    return streaming_plan(b, hw, c, itemsize)


def _stats(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, 2, C) f32: mean and 1 / sqrt(var + eps) over H, W."""
    mean = x32.mean(dim=(1, 2))
    var = x32.square().mean(dim=(1, 2)) - mean.square()
    return torch.stack([mean, torch.reciprocal(torch.sqrt(var + eps))], 1)


def _normalized(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """``(x - mean.to(dtype)) * scale.to(dtype)`` in x's dtype, rounded
    after each op."""
    mean = stats[:, 0, None, None, :]
    scale = stats[:, 1, None, None, :]
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False, return_stats: bool = False,
                        residual: torch.Tensor | None = None):
    """The JAX formula of ``nirgan_tpu/ops/norm.py`` exactly: f32 statistics
    with var = E[x^2] - E[x]^2 and no clamp, then
    ``(x - mean.to(dtype)) * rsqrt(var + eps).to(dtype)`` in x's dtype.
    ``torch.nn.InstanceNorm2d`` is not this formula.  ``residual`` is added
    to the result (after the ReLU, if any) in x's dtype.  With
    ``return_stats`` also the (B, 2, C) f32 mean and scale."""
    stats = _stats(x.float(), eps)
    y = _normalized(x, stats)
    y = torch.relu(y) if relu else y
    y = residual + y if residual is not None else y
    return (y, stats) if return_stats else y


def instance_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                            stats: torch.Tensor,
                            relu: bool = False) -> torch.Tensor:
    """The backward of ``_bwd_kernel`` in f32: with y = (x - mean) * r,
    ``dx = r * (g - mean(g) - y * mean(g * y))``, dx in x's dtype.  Where
    the forward fused the ReLU (``relu``), g is first masked by the sign of
    the forward's value, recomputed from x and ``stats`` as the forward
    rounds it: the same bits as ``out > 0``."""
    g32 = g.float()
    if relu:
        g32 = g32 * (_normalized(x, stats) > 0)
    mean = stats[:, 0, None, None, :]
    r = stats[:, 1, None, None, :]
    y = (x.float() - mean) * r
    dx = r * (g32 - g32.mean(dim=(1, 2), keepdim=True)
              - y * (g32 * y).mean(dim=(1, 2), keepdim=True))
    return dx.to(x.dtype)


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


def _like(x: torch.Tensor, t: torch.Tensor, what: str, name: str) -> None:
    _lib.require(t.is_cuda and t.dtype == x.dtype and t.shape == x.shape
                 and t.is_contiguous(), name,
                 f"{what} must be a contiguous CUDA tensor like x")


def _plan_args(plan: Plan) -> tuple:
    return (1 if plan.regime == "resident" else 2, plan.group, plan.cluster,
            plan.threads, plan.slabs, plan.smem_bytes)


def _scratch(x: torch.Tensor, plan: Plan) -> torch.Tensor | None:
    """The partial sums' f32 buffer, which only the streaming regime has."""
    if plan.regime == "resident":
        return None
    b, c = x.shape[0], x.shape[3]
    return torch.empty((b, plan.slabs, 2, c), device=x.device,
                       dtype=torch.float32)


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _launch(x: torch.Tensor, eps: float, relu: bool,
            residual: torch.Tensor | None,
            plan: Plan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: (y, stats), under ``launch_plan``'s plan.  Only a
    measurement of other plans gives one; the C entry refuses a plan its
    kernels cannot take."""
    code = _check(x, NAME)
    b, h, w, c = x.shape
    if residual is not None:
        _like(x, residual, "residual", NAME)
    plan = plan or launch_plan(b, h * w, c, x.element_size(), False)
    part = _scratch(x, plan)
    stats = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    _lib.require(_lib.aligned(x, y, *([] if residual is None else [residual])),
                 NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm(
        x.device.index, code, x.data_ptr(), _ptr(residual), _ptr(part),
        stats.data_ptr(), y.data_ptr(), b, h * w, c, *_plan_args(plan),
        float(eps), int(relu), _lib.stream_of(x))
    _lib.check(err, NAME)
    instance_norm_cuda.launches += 1
    return y, stats


def instance_norm_cuda(x: torch.Tensor, eps: float = 1e-5,
                       relu: bool = False, return_stats: bool = False,
                       residual: torch.Tensor | None = None):
    """Launch kernel B on contiguous NHWC bf16 or f32; C must be a multiple
    of 8.  ``residual``, like x, is added to the result.  With
    ``return_stats`` also the (B, 2, C) f32 mean and scale."""
    y, stats = _launch(x, eps, relu, residual)
    return (y, stats) if return_stats else y


instance_norm_cuda.launches = 0


def _launch_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                relu: bool, plan: Plan | None = None) -> torch.Tensor:
    """Kernel B4: dx, under ``launch_plan``'s plan unless one is given."""
    req = _lib.require
    code = _check(x, BWD_NAME)
    b, h, w, c = x.shape
    _like(x, g, "g", BWD_NAME)
    req(stats.dtype == torch.float32 and tuple(stats.shape) == (b, 2, c)
        and stats.is_contiguous() and stats.is_cuda, BWD_NAME,
        f"stats must be a contiguous ({b}, 2, {c}) f32 CUDA tensor")
    plan = plan or launch_plan(b, h * w, c, x.element_size(), True)
    part = _scratch(x, plan)
    dx = torch.empty_like(x)
    req(_lib.aligned(x, g, dx), BWD_NAME, "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm_bwd(
        x.device.index, code, x.data_ptr(), g.data_ptr(), stats.data_ptr(),
        _ptr(part), dx.data_ptr(), b, h * w, c, *_plan_args(plan), int(relu),
        _lib.stream_of(x))
    _lib.check(err, BWD_NAME)
    instance_norm_bwd_cuda.launches += 1
    return dx


def instance_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                           stats: torch.Tensor,
                           relu: bool = False) -> torch.Tensor:
    """Launch kernel B4: the arguments of ``instance_norm_bwd_plain``, x and
    g contiguous NHWC in one dtype on the card, stats (B, 2, C) f32."""
    return _launch_bwd(x, g, stats, relu)


instance_norm_bwd_cuda.launches = 0


def max_active_clusters(x: torch.Tensor, plan: Plan, backward: bool) -> int:
    """How many clusters of a resident ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``): the H100's GPCs are uneven, so
    fewer large clusters fit than SMs / cluster."""
    n = _lib.library().nirgan_instance_norm_max_clusters(
        x.device.index, _lib.dtype_code(x, NAME), int(backward), x.shape[0],
        x.shape[3], plan.cluster, plan.threads, plan.smem_bytes)
    _lib.check(max(0, -n), NAME)
    return n


class InstanceNorm(torch.autograd.Function):
    """Forward kernel B, backward kernel B4 (the plain versions on the CPU).
    Saves x and the forward's f32 statistics, never the output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, residual: torch.Tensor | None,
                eps: float, relu: bool) -> torch.Tensor:
        fwd = instance_norm_cuda if _lib.route(x, NAME) else instance_norm_plain
        y, stats = fwd(x, eps, relu, return_stats=True, residual=residual)
        ctx.relu = relu
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, stats = ctx.saved_tensors
        g = g.contiguous()
        bwd = (instance_norm_bwd_cuda if _lib.route(x, BWD_NAME)
               else instance_norm_bwd_plain)
        # the skip passes its cotangent on unchanged
        return (bwd(x, g, stats, ctx.relu),
                g if ctx.needs_input_grad[1] else None, None, None)


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable per-sample, per-channel spatial normalisation of NHWC
    x (torch defaults: eps 1e-5, biased variance) with f32 statistics,
    normalised in x's dtype; ``relu=True`` applies ReLU to the result and
    ``residual`` is then added to it in x's dtype (both exact, fused in the
    kernel)."""
    return InstanceNorm.apply(x, residual, eps, relu)
