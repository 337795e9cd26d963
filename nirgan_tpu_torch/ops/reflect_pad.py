"""The trunk backward's reflect pad at pad 1 and its adjoint, one pass each
(``csrc/reflect_pad.cu``).

Kernel A's forward mirrors the border inside the kernel and saves only x,
so ``trunk_conv_bwd`` rebuilds the padded input for the weight gradient
and folds the padded input gradient back onto x.  These two ops do that:
``reflect_pad`` (x (B, H, W, C) NHWC -> a contiguous (B, H+2, W+2, C)) and
``reflect_pad_adjoint`` (the padded cotangent -> a contiguous (B, H, W,
C)).  No TPU kernel stands behind them: the JAX package leaves the pad and
its transpose to XLA.  The pad is an exact copy; the adjoint is the plain
version's adds in its order and rounding, so both equal the plain
versions bit for bit.  The source's header has the design.

Each is one operator, ``torch.ops.nirgan.reflect_pad`` and
``reflect_pad_adjoint`` (``_registry``), so a trace of the trunk conv's
backward reaches their fake implementations.  Routing is by device alone,
not a fallback: a CPU tensor takes the plain versions (``ops/pad.py``'s
``reflect_pad2d`` and ``reflect_pad2d_adjoint`` at pad 1); a CUDA tensor
launches the kernels, which take f32, bf16 and f16 at any channel count,
or the call raises (``launch_plan``).
"""

from __future__ import annotations

import functools

import torch

from nirgan_tpu_torch.ops import _lib, _registry
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad2d_adjoint

NAME = "reflect_pad"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reflect_pad_plain(x: torch.Tensor) -> torch.Tensor:
    return reflect_pad2d(x, 1)


def reflect_pad_adjoint_plain(g: torch.Tensor) -> torch.Tensor:
    return reflect_pad2d_adjoint(g, 1).contiguous()


# by shape alone: kept, so a call's host time does not repeat it
@functools.lru_cache(maxsize=256)
def launch_plan(dtype: torch.dtype, shape: tuple, adjoint: bool) -> tuple:
    """The output's shape of a launch on a tensor of ``shape`` in ``dtype``:
    x (B, H, W, C) for the pad, the padded cotangent (B, H+2, W+2, C) for
    the adjoint.  Raises ValueError on what the kernels do not take."""
    req = _lib.require
    req(dtype in DTYPE_CODES, NAME,
        f"dtype {dtype} not supported (float32, bfloat16, float16)")
    req(len(shape) == 4, NAME, "the tensor must be (B, H, W, C)")
    b, h, w, c = shape
    if adjoint:
        h, w = h - 2, w - 2
    req(h >= 2 and w >= 2, NAME, "reflect padding needs H, W >= 2")
    req(0 < b * (h + 2) * (w + 2) * c < 2 ** 31, NAME, "need 0 < B*(H+2)*(W+2)*C < 2^31")
    return (b, h, w, c) if adjoint else (b, h + 2, w + 2, c)


def _launch(t: torch.Tensor, adjoint: bool) -> torch.Tensor:
    _lib.require(t.is_cuda, NAME, "the tensor must be a CUDA tensor")
    out_shape = launch_plan(t.dtype, tuple(t.shape), adjoint)
    t = t.contiguous()
    out = torch.empty(out_shape, device=t.device, dtype=t.dtype)
    b, h, w, c = out_shape if adjoint else t.shape
    lib = _lib.library()
    entry = lib.nirgan_reflect_pad_adjoint if adjoint else lib.nirgan_reflect_pad
    err = entry(t.device.index, DTYPE_CODES[t.dtype], t.data_ptr(), out.data_ptr(), b, h, w, c,
                _lib.stream_of(t))
    _lib.check(err, NAME)
    return out


def reflect_pad_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the pad kernel on NHWC x on a CUDA device."""
    xp = _launch(x, adjoint=False)
    reflect_pad_cuda.launches += 1
    return xp


def reflect_pad_adjoint_cuda(g: torch.Tensor) -> torch.Tensor:
    """Launch the adjoint kernel on an NHWC padded cotangent on a CUDA
    device."""
    dx = _launch(g, adjoint=True)
    reflect_pad_adjoint_cuda.launches += 1
    return dx


reflect_pad_cuda.launches = 0
reflect_pad_adjoint_cuda.launches = 0


def pad_route(x: torch.Tensor):
    """The pad x takes: the plain version on the CPU, the kernel on a card."""
    return reflect_pad_cuda if _lib.route(x, NAME) else reflect_pad_plain


def adjoint_route(g: torch.Tensor):
    """The adjoint the cotangent g takes, by the same rule."""
    return reflect_pad_adjoint_cuda if _lib.route(g, NAME) else reflect_pad_adjoint_plain


def _fake_shape(t: torch.Tensor, adjoint: bool) -> tuple:
    """The output's shape; on a card ``launch_plan`` checks what the kernel
    would get."""
    if _lib.route(t, NAME):
        return launch_plan(t.dtype, tuple(t.shape), adjoint)
    b, h, w, c = t.shape
    return (b, h - 2, w - 2, c) if adjoint else (b, h + 2, w + 2, c)


_registry.define("reflect_pad(Tensor x) -> Tensor", lambda x: pad_route(x)(x),
                 lambda x: x.new_empty(_fake_shape(x, False)))
_registry.define("reflect_pad_adjoint(Tensor g) -> Tensor", lambda g: adjoint_route(g)(g),
                 lambda g: g.new_empty(_fake_shape(g, True)))


def reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """``reflect_pad2d(x, 1)`` of NHWC x: a contiguous (B, H+2, W+2, C)."""
    return torch.ops.nirgan.reflect_pad(x)


def reflect_pad_adjoint(g: torch.Tensor) -> torch.Tensor:
    """``reflect_pad2d_adjoint(g, 1)`` of an NHWC cotangent of the padded
    shape: a contiguous (B, H, W, C)."""
    return torch.ops.nirgan.reflect_pad_adjoint(g)
