"""Spatial padding (NHWC), counterpart of ``nirgan_tpu/ops/pad.py``."""

import torch
import torch.nn.functional as F


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection padding, torch ``nn.ReflectionPad2d`` semantics, on an NHWC
    tensor; returns a contiguous NHWC tensor."""
    if pad == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def reflect_pad2d_adjoint(g: torch.Tensor, pad: int) -> torch.Tensor:
    """The adjoint of ``reflect_pad2d`` (pad smaller than each side) on an
    NHWC cotangent of the padded shape: a copy of the interior, then each
    mirrored row, column and corner added onto its source in a fixed order.
    torch's ``reflection_pad2d_backward`` adds with atomics on a card, so
    its result changes from run to run; this one does not."""
    if pad == 0:
        return g
    p = pad
    h, w = g.shape[1] - 2 * p, g.shape[2] - 2 * p

    def edges(n):
        # (padded index, source index): i mirrors p - i, n + p + i mirrors n - 2 - i
        return ([(i, p - i) for i in range(p)]
                + [(n + p + i, n - 2 - i) for i in range(p)])

    out = g[:, p:p + h, p:p + w].clone()
    for r, s in edges(h):
        out[:, s] += g[:, r, p:p + w]
    for c, s in edges(w):
        out[:, :, s] += g[:, p:p + h, c]
    for r, sr in edges(h):
        for c, sc in edges(w):
            out[:, sr, sc] += g[:, r, c]
    return out


def replicate_pad2d_adjoint(g: torch.Tensor, pad: int) -> torch.Tensor:
    """The adjoint of ``replicate_pad2d`` on an NHWC cotangent of the padded
    shape: the top and bottom pad rows added onto the first and last rows,
    then the left and right pad columns onto the first and last columns,
    each in a fixed order.  torch's ``replication_pad2d_backward`` adds with
    atomics on a card, so its result changes from run to run; this one does
    not."""
    if pad == 0:
        return g
    p = pad
    h, w = g.shape[1] - 2 * p, g.shape[2] - 2 * p
    rows = g[:, p:p + h].clone()
    for r in range(p):
        rows[:, 0] += g[:, r]
    for r in range(p):
        rows[:, h - 1] += g[:, p + h + r]
    out = rows[:, :, p:p + w].clone()
    for c in range(p):
        out[:, :, 0] += rows[:, :, c]
    for c in range(p):
        out[:, :, w - 1] += rows[:, :, p + w + c]
    return out


class ReplicatePad2d(torch.autograd.Function):
    """Edge padding (``jnp.pad`` mode "edge", torch ``nn.ReplicationPad2d``)
    of NHWC x, whose backward is ``replicate_pad2d_adjoint``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pad: int) -> torch.Tensor:
        ctx.pad = pad
        y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return replicate_pad2d_adjoint(g, ctx.pad), None


def replicate_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate (edge) padding of an NHWC tensor; a contiguous result whose
    gradient adds in a fixed order."""
    return x if pad == 0 else ReplicatePad2d.apply(x, pad)


def zero_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero padding of an NHWC tensor (its gradient is a slice)."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, pad, pad, pad, pad)).contiguous()


def _reflect_index(n: int, size: int, device) -> torch.Tensor:
    """Source index of each of ``size`` positions when a side of ``n`` is
    reflect-padded at its end: a triangle wave of period 2(n - 1), which is
    what numpy's and ``jnp.pad``'s reflect mode give for any pad, also one
    longer than the side."""
    j = torch.arange(size, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    i = j % period
    return torch.where(i >= n, period - i, i)


def reflect_pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reflect-pad an NHWC tensor at the bottom and right up to (h, w), as
    ``jnp.pad(x, ((0, 0), (0, h - H), (0, w - W), (0, 0)), "reflect")``
    does, pads longer than the side included."""
    H, W = x.shape[1], x.shape[2]
    if (H, W) == (h, w):
        return x
    x = x.index_select(1, _reflect_index(H, h, x.device))
    return x.index_select(2, _reflect_index(W, w, x.device)).contiguous()
