"""Weight packing for the tensor-core kernels (``csrc/hopper.cuh``).

A wgmma B operand lies in shared memory as rows of 128 bytes (64 bf16 of
the reduced dimension K for one output column n) in the 128-byte swizzle:
the 16-byte chunk ``c`` of row ``n`` sits at chunk ``c ^ (n % 8)``.  The
weights are the same for every block of a launch, so the wrapper lays them
out in that order once, as one contiguous image of ``N x 128`` bytes for each
(tap, 64-wide slice of K), and the kernel fills a stage with one bulk copy.
Plain tensor code, so the CPU tests reach it.

The head's mma.sync kernel takes its weight as a Toeplitz image
(``head_toeplitz``) in the register order of the instruction's B operand
(``mma_b_fragments``), so a warp reads a fragment as one coalesced 256-byte
line straight into registers.

``laid_out`` keeps a weight's kernel layout until the weight changes, so a
forward with fixed weights (serving, validation) packs nothing, and a
train step packs each weight once after the optimizer has written it.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable

import torch

SLICE = 64  # K values in a row: 128 bytes of bf16


@functools.lru_cache(maxsize=None)
def _swizzle_index(device: torch.device) -> torch.Tensor:
    """For 8 rows of 8 chunks flattened to 64: position r * 8 + p takes
    chunk p ^ r of row r (the XOR is its own inverse)."""
    r = torch.arange(8, device=device)[:, None]
    p = torch.arange(8, device=device)[None, :]
    return (r * 8 + (p ^ r)).reshape(64)


def pack_b128(w: torch.Tensor) -> torch.Tensor:
    """w (T, N, K), N % 8 == 0 and K % 64 == 0 -> (T, K // 64, N, 8, 8):
    image (t, s) holds w[t, :, 64 s : 64 s + 64] with the chunks of row n
    permuted by ``c -> c ^ (n % 8)``.  One copy and one ``index_select``,
    whatever w's strides."""
    t, n, k = w.shape
    if k % SLICE or n % 8:
        raise ValueError(f"pack_b128: N = {n} must be a multiple of 8 and "
                         f"K = {k} of {SLICE}")
    v = w.unflatten(2, (k // SLICE, 8, 8)).unflatten(1, (n // 8, 8))
    v = v.permute(0, 3, 1, 2, 4, 5).reshape(t, k // SLICE, n // 8, 64, 8)
    return v.index_select(3, _swizzle_index(w.device)).view(
        t, k // SLICE, n, 8, 8)


def taps_first(weight: torch.Tensor) -> torch.Tensor:
    """(O, I, ky, kx) -> (ky, kx, I, O) contiguous: the layout of the WMMA
    and SIMT kernels, whose weights are not packed."""
    return weight.permute(2, 3, 1, 0).contiguous()


def head_toeplitz(w: torch.Tensor, cols: int = 8) -> torch.Tensor:
    """w (ky, kx, C) -> (ky, (kx + cols - 1) * C, cols): the weight of
    ``cols`` neighbouring output columns as one matrix a kernel row.  With
    an input row's pixels x0 .. x0 + kx + cols - 2 flattened to (j, c),
    ``out[x0 + p] = sum_dy row[dy] @ T[dy][:, p]``: ``T[dy, j * C + c, p] =
    w[dy, j - p, c]`` where ``0 <= j - p < kx``, else 0."""
    ky, kx, c = w.shape
    t = w.new_zeros((ky, kx + cols - 1, c, cols))
    for p in range(cols):
        t[:, p:p + kx, :, p] = w
    return t.reshape(ky, (kx + cols - 1) * c, cols)


def mma_b_fragments(t: torch.Tensor) -> torch.Tensor:
    """t (T, K, 8), K % 16 == 0 -> (T, K // 16, 32, 4): each 16 x 8 block in
    the register order of ``mma.sync.m16n8k16``'s column-major B operand.
    Lane ``l`` holds column ``l // 4`` at k = 2 (l % 4) + (0, 1, 8, 9)."""
    n_t, k, n = t.shape
    if k % 16 or n != 8:
        raise ValueError(f"mma_b_fragments: K = {k} must be a multiple of 16 "
                         f"and N = {n} must be 8")
    v = t.reshape(n_t, k // 16, 2, 4, 2, 8)  # (.., hi, q, e, n): k = 8 hi + 2 q + e
    return v.permute(0, 1, 5, 3, 2, 4).reshape(n_t, k // 16, 32, 4).contiguous()


# id(weight) -> (weak reference to the weight, key, the layout); an entry
# goes when its weight does
_LAID_OUT: dict = {}


def laid_out(weight: torch.Tensor, device: torch.device, dtype: torch.dtype,
             layout: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``layout(weight.to(device, dtype))``, computed once for as long as
    the weight keeps its value: the result is kept by the weight's identity,
    its storage address and its version counter, which every in-place write
    raises (an optimizer step, ``load_state_dict``, ``copy_``).  A write
    through the legacy ``weight.data`` view raises no counter and is not
    seen.  A tensor made under ``torch.inference_mode`` has no counter and
    is laid out on every call.  The kept layout is made outside inference
    mode, so a training step may use a layout that serving made first."""
    if weight.is_inference():
        return layout(weight.to(device=device, dtype=dtype))
    key = (weight._version, weight.data_ptr(), device, dtype, layout)
    kept = _LAID_OUT.get(id(weight))
    if kept is not None and kept[0]() is weight and kept[1] == key:
        return kept[2]
    with torch.inference_mode(False):
        out = layout(weight.detach().to(device=device, dtype=dtype))
    ident = id(weight)
    ref = weakref.ref(weight, lambda _, ident=ident: _LAID_OUT.pop(ident, None))
    _LAID_OUT[ident] = (ref, key, out)
    return out
