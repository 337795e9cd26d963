"""Seeded weights and sub-seeds.  The benchmark makes every weight itself,
on the device, in one draw for all the matrices of a network (init_type
normal: N(0, init_gain), biases zero), and hands the same tensors to the
program and to the reference."""

from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of ``seed``: stream 1 G's
    weights, 2 D's, 3 the traffic, 4 the sample that is checked, 5 the
    SatCLIP tower's weights."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def make(shapes: dict, seed: int, device, gain: float = 0.02,
         scalars: dict | None = None) -> dict:
    """name -> f32 tensor on ``device``: every leaf of two or more
    dimensions from N(0, gain) in one draw, in ``shapes``' order; vectors
    zero; 0-d leaves from ``scalars`` (the inject route's scale)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = [n for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[n]) for n in mats)
    flat = torch.randn(total, generator=gen, device=device) * gain
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape)
            at += k
        elif len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full((), float((scalars or {})[name]), device=device)
    return out
