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

``instance_norm`` is one operator, ``torch.ops.nirgan.instance_norm``
(``_registry``; it returns the output and the f32 statistics), whose
gradient is a second one, ``torch.ops.nirgan.instance_norm_bwd``: a CUDA
tensor launches the kernels in both directions or raises, a CPU tensor
takes the plain versions, so the CPU runs the same graph wiring as the
card.  The backward operator is itself differentiable (``gradient_penalty``
trains D through it): its autograd formula is the second-order terms in
PyTorch ops (``instance_norm_bwd_bwd``), where the JAX package lets XLA
differentiate its norm twice.  It is the entry the models call,
the counterpart of ``nirgan_tpu/ops/norm.py`` (affine-free, stat-free
everywhere, reference ``model/networks.py:30``).

The split forward serves one shard of an H-sharded tile
(``parallel/spatial.py``), whose statistics cover every shard:
``instance_norm_sums`` (``nirgan::instance_norm_sums``) gives this shard's
Sigma x and Sigma x^2 as exact (hi, lo) pairs, (B, 4, C); the shards'
sums are gathered, and ``instance_norm_apply`` (``nirgan::instance_norm_apply``)
adds them in shard order and normalises this shard with the tile's pixel
count, the ReLU and the skip fused as in kernel B.  On a card both launch
the streaming regime's kernels; on the CPU ``instance_norm_sums_plain``
and ``instance_norm_apply_plain`` are the JAX formula over the sums.
"""


from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from nirgan_tpu_torch.ops import _lib, _registry

NAME = "instance_norm"
BWD_NAME = "instance_norm_bwd"
SUMS_NAME = "instance_norm_sums"
APPLY_NAME = "instance_norm_apply"
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


# by shape alone: kept, so a call's host time does not repeat it
@functools.lru_cache(maxsize=256)
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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 where it is f64 (the plain versions' gradient
    checks run in f64)."""
    return x if x.dtype == torch.float64 else x.float()


def _stats(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, 2, C) f32 (f64 for f64 x): mean and 1 / sqrt(var + eps) over H,
    W."""
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
    stats = _stats(_wide(x), eps)
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
    g32 = _wide(g)
    if relu:
        g32 = g32 * (_normalized(x, stats) > 0)
    r = stats[:, 1, None, None, :]
    return (r * _project(g32, _y(x, stats))).to(x.dtype)


def _y(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """The normalised x in f32 (f64 for f64 x): (x - mean) * r."""
    return (_wide(x) - stats[:, 0, None, None, :]) * stats[:, 1, None, None, :]


def _project(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a - mean(a) - y * mean(a * y) over H, W: the backward's map, which is
    its own adjoint."""
    return (a - a.mean(dim=(1, 2), keepdim=True)
            - y * (a * y).mean(dim=(1, 2), keepdim=True))


def instance_norm_bwd_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                          relu: bool, v: torch.Tensor) -> tuple:
    """The second-order terms of the instance norm, in PyTorch ops: given v,
    the cotangent of the backward's dx = r P(g') with g' = g * mask, P a =
    a - mean(a) - y mean(a y) and y = (x - mean) r, returns (the cotangent
    of x, of g):

        dg = mask * r P(v)
        dx = -r^2 (A y + mean(v y) P(g') + mean(g' y) P(v)),
        A  = mean(v g') - mean(g') mean(v) - mean(g' y) mean(v y),

    from dy = r P(dx) and dr = -r^2 mean(y dx), the statistics' dependence
    on x included.  The fused ReLU's mask is constant almost everywhere, so
    it only masks g.  In f32 (f64 for f64 x), each result in its input's
    dtype.  The JAX package has no kernel here: XLA differentiates its norm
    twice (``nirgan_tpu/losses/gan.py:40``)."""
    mask = (_normalized(x, stats) > 0) if relu else None
    gm = _wide(g) if mask is None else _wide(g) * mask
    v32 = _wide(v)
    y = _y(x, stats)
    r = stats[:, 1, None, None, :]

    def mean(a):
        return a.mean(dim=(1, 2), keepdim=True)

    pv, pg = _project(v32, y), _project(gm, y)
    vy, gy = mean(v32 * y), mean(gm * y)
    a = mean(v32 * gm) - mean(gm) * mean(v32) - gy * vy
    dg = r * pv if mask is None else r * pv * mask
    dx = -r.square() * (a * y + vy * pg + gy * pv)
    return dx.to(x.dtype), dg.to(g.dtype)


def instance_norm_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, 4, C): Sigma x and Sigma x^2 over H, W in f32 (f64 for f64 x),
    then the low parts of the kernel's exact pairs, zero here."""
    x32 = _wide(x)
    a, q = x32.sum(dim=(1, 2)), x32.square().sum(dim=(1, 2))
    zero = torch.zeros_like(a)
    return torch.stack([a, q, zero, zero], 1)


def stats_from_sums(parts: torch.Tensor, count: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, 2, C) mean and 1 / sqrt(var + eps) from the (B, P, 4, C) sums of
    P shards, added in shard order, over ``count`` pixels: ``_stats``'s
    formula, var = E[x^2] - E[x]^2 without a clamp."""
    total = parts[:, 0]
    for i in range(1, parts.shape[1]):
        total = total + parts[:, i]
    n = torch.full_like(total[:, 0], count)  # a true division on every device
    mean = (total[:, 0] + total[:, 2]) / n
    var = (total[:, 1] + total[:, 3]) / n - mean.square()
    return torch.stack([mean, torch.reciprocal(torch.sqrt(var + eps))], 1)


def instance_norm_apply_plain(x: torch.Tensor, parts: torch.Tensor, count: int,
                              eps: float = 1e-5, relu: bool = False,
                              residual: torch.Tensor | None = None) -> torch.Tensor:
    """``instance_norm_plain`` with the statistics of ``stats_from_sums``:
    this shard of a tile normalised with the tile's statistics."""
    y = _normalized(x, stats_from_sums(parts, count, eps))
    y = torch.relu(y) if relu else y
    return residual + y if residual is not None else y


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
    """The partial sums' f32 buffer, which only the streaming regime has: a
    slab's two sums as pairs (hi, hi, lo, lo) that add exactly."""
    if plan.regime == "resident":
        return None
    b, c = x.shape[0], x.shape[3]
    return torch.empty((b, plan.slabs, 4, c), device=x.device,
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


def instance_norm_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the split forward's sums (``nirgan_instance_norm_sums``) on
    contiguous NHWC bf16 or f32, C a multiple of 8: (B, 4, C) f32 exact
    pairs, the arguments and result of ``instance_norm_sums_plain``."""
    code = _check(x, SUMS_NAME)
    b, h, w, c = x.shape
    plan = streaming_plan(b, h * w, c, x.element_size())
    part = _scratch(x, plan)
    sums = torch.empty((b, 4, c), device=x.device, dtype=torch.float32)
    _lib.require(_lib.aligned(x), SUMS_NAME, "x must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm_sums(
        x.device.index, code, x.data_ptr(), part.data_ptr(), sums.data_ptr(), b,
        h * w, c, plan.group, plan.slabs, _lib.stream_of(x))
    _lib.check(err, SUMS_NAME)
    instance_norm_sums_cuda.launches += 1
    return sums


instance_norm_sums_cuda.launches = 0


def instance_norm_apply_cuda(x: torch.Tensor, parts: torch.Tensor, count: int,
                             eps: float = 1e-5, relu: bool = False,
                             residual: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the split forward's elementwise pass
    (``nirgan_instance_norm_apply``): the arguments and result of
    ``instance_norm_apply_plain``, ``parts`` the (B, P, 4, C) f32 sums of
    the P shards on the card."""
    req = _lib.require
    code = _check(x, APPLY_NAME)
    b, h, w, c = x.shape
    req(parts.is_cuda and parts.dtype == torch.float32 and parts.dim() == 4
        and tuple(parts.shape[::2]) == (b, 4) and parts.shape[3] == c
        and parts.is_contiguous(), APPLY_NAME,
        f"parts must be a contiguous ({b}, P, 4, {c}) f32 CUDA tensor")
    req(count > 0, APPLY_NAME, f"count must be positive, got {count}")
    if residual is not None:
        _like(x, residual, "residual", APPLY_NAME)
    plan = streaming_plan(b, h * w, c, x.element_size())
    y = torch.empty_like(x)
    req(_lib.aligned(x, y, *([] if residual is None else [residual])), APPLY_NAME,
        "tensors must be 16-byte aligned")
    err = _lib.library().nirgan_instance_norm_apply(
        x.device.index, code, x.data_ptr(), _ptr(residual), parts.data_ptr(),
        parts.shape[1], y.data_ptr(), b, h * w, c, plan.group, plan.slabs, int(count),
        float(eps), int(relu), _lib.stream_of(x))
    _lib.check(err, APPLY_NAME)
    instance_norm_apply_cuda.launches += 1
    return y


instance_norm_apply_cuda.launches = 0


def max_active_clusters(x: torch.Tensor, plan: Plan, backward: bool) -> int:
    """How many clusters of a resident ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``): the H100's GPCs are uneven, so
    fewer large clusters fit than SMs / cluster."""
    n = _lib.library().nirgan_instance_norm_max_clusters(
        x.device.index, _lib.dtype_code(x, NAME), int(backward), x.shape[0],
        x.shape[3], plan.cluster, plan.threads, plan.smem_bytes)
    _lib.check(max(0, -n), NAME)
    return n


def _routed(x, residual, eps, relu):
    """``nirgan::instance_norm``'s CPU and CUDA implementation: kernel B
    on a card, its plain version on the CPU; (y, stats)."""
    fwd = instance_norm_cuda if _lib.route(x, NAME) else instance_norm_plain
    return fwd(x, eps, relu, return_stats=True, residual=residual)


def _fake(x, residual, eps, relu):
    _lib.route(x, NAME)
    stats_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (x.new_empty(x.shape),
            x.new_empty((x.shape[0], 2, x.shape[-1]), dtype=stats_dtype))


def _setup(ctx, inputs, output):
    x, _, _, ctx.relu = inputs
    stats = output[1]
    ctx.mark_non_differentiable(stats)
    ctx.save_for_backward(x, stats)


def _backward(ctx, g, _):
    x, stats = ctx.saved_tensors
    # the skip passes its cotangent on unchanged
    return (torch.ops.nirgan.instance_norm_bwd(x, g, stats, ctx.relu),
            g if ctx.needs_input_grad[1] else None, None, None)


def _routed_bwd(x, g, stats, relu):
    """``nirgan::instance_norm_bwd``'s CPU and CUDA implementation: kernel
    B4 on a card, its plain version on the CPU."""
    bwd = instance_norm_bwd_cuda if _lib.route(x, BWD_NAME) else instance_norm_bwd_plain
    return bwd(x, g.contiguous(), stats, relu)


def _fake_bwd(x, g, stats, relu):
    _lib.route(x, BWD_NAME)
    return x.new_empty(x.shape)


def _setup_bwd(ctx, inputs, output):
    x, g, stats, ctx.relu = inputs
    ctx.save_for_backward(x, g, stats)


def _backward_bwd(ctx, v):
    """The second-order terms, in PyTorch ops; ``stats`` are the forward's,
    a function of x that they account for."""
    x, g, stats = ctx.saved_tensors
    dx, dg = instance_norm_bwd_bwd(x, g, stats, ctx.relu, v)
    return dx, dg, None, None


_registry.define("instance_norm_bwd(Tensor x, Tensor g, Tensor stats, bool relu) -> Tensor",
                 _routed_bwd, _fake_bwd, _backward_bwd, _setup_bwd)
_registry.define("instance_norm(Tensor x, Tensor? residual, float eps, bool relu) "
                 "-> (Tensor, Tensor)", _routed, _fake, _backward, _setup)


def _routed_sums(x):
    """``nirgan::instance_norm_sums``'s CPU and CUDA implementation."""
    return (instance_norm_sums_cuda if _lib.route(x, SUMS_NAME)
            else instance_norm_sums_plain)(x)


def _fake_sums(x):
    _lib.route(x, SUMS_NAME)
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.new_empty((x.shape[0], 4, x.shape[-1]), dtype=dtype)


def _routed_apply(x, parts, residual, count, eps, relu):
    """``nirgan::instance_norm_apply``'s CPU and CUDA implementation."""
    fn = instance_norm_apply_cuda if _lib.route(x, APPLY_NAME) else instance_norm_apply_plain
    return fn(x, parts, count, eps, relu, residual)


def _fake_apply(x, parts, residual, count, eps, relu):
    _lib.route(x, APPLY_NAME)
    return x.new_empty(x.shape)


_registry.define("instance_norm_sums(Tensor x) -> Tensor", _routed_sums, _fake_sums)
_registry.define("instance_norm_apply(Tensor x, Tensor parts, Tensor? residual, int count, "
                 "float eps, bool relu) -> Tensor", _routed_apply, _fake_apply)


def instance_norm_sums(x: torch.Tensor) -> torch.Tensor:
    """This shard's sums for the split forward, (B, 4, C) f32: kernel B's
    sums on a card, ``instance_norm_sums_plain`` on the CPU.  Serving
    only: no gradient."""
    return torch.ops.nirgan.instance_norm_sums(x)


def instance_norm_apply(x: torch.Tensor, parts: torch.Tensor, count: int,
                        eps: float = 1e-5, relu: bool = False,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """This shard normalised with the statistics of the (B, P, 4, C) sums
    of all P shards over ``count`` pixels, ReLU and skip as in
    ``instance_norm``: kernel B's elementwise pass on a card,
    ``instance_norm_apply_plain`` on the CPU.  Serving only."""
    return torch.ops.nirgan.instance_norm_apply(x, parts, residual, count, eps, relu)


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable per-sample, per-channel spatial normalisation of NHWC
    x (torch defaults: eps 1e-5, biased variance) with f32 statistics,
    normalised in x's dtype; ``relu=True`` applies ReLU to the result and
    ``residual`` is then added to it in x's dtype (both exact, fused in the
    kernel).  Forward kernel B, backward kernel B4 (the plain versions on
    the CPU); x and the statistics are saved, never the output."""
    return torch.ops.nirgan.instance_norm(x, residual, eps, relu)[0]
