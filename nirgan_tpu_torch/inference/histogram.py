"""Histogram matching exact to ``skimage.exposure.match_histograms``,
batched on the device; counterpart of ``nirgan_tpu/inference/histogram.py``.

skimage's float path assigns every source pixel the template value
interpolated at its group-cumulative quantile:

    src_q[p] = (# source pixels <= src[p]) / n          (ties share one q)
    nodes    = {(cum_count(v) / m, v) : v unique template value}
    out[p]   = np.interp(src_q[p], node_q, node_v)

Both pieces are fixed-shape operations on the sorted arrays: ``src_q`` is a
right-side ``searchsorted``; the interpolation nodes are where a template
value-group ends, found per query by a ``searchsorted`` over the
group-quantile array.  Tied source pixels get one shared value and tied
template values collapse to one node, as in skimage.
"""

from __future__ import annotations

import torch

__all__ = ["histogram_match"]


def histogram_match(image: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) source, (B, h, w, 1) reference -> the source remapped to
    the reference's intensity distribution, per batch element, in the
    source's dtype.  Different pixel counts need no resampling: each array
    is divided by its own size."""
    b = image.shape[0]
    src = image.reshape(b, -1).float()
    ref = torch.sort(reference.reshape(b, -1).float(), dim=1).values
    n, m = src.shape[1], ref.shape[1]
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=src.device)
    inv_m = torch.tensor(1.0 / m, dtype=torch.float32, device=src.device)
    src_sorted = torch.sort(src, dim=1).values
    q = torch.searchsorted(src_sorted, src, right=True).float() * inv_n
    qt = torch.searchsorted(ref, ref, right=True).float() * inv_m
    # the first position whose group quantile >= q starts the bracketing
    # group (upper node); i - 1 ends the previous group (lower node)
    i = torch.searchsorted(qt, q).clamp(0, m - 1)
    i0 = (i - 1).clamp(min=0)
    q0, v0 = qt.gather(1, i0), ref.gather(1, i0)
    q1, v1 = qt.gather(1, i), ref.gather(1, i)
    gap = q1 > q0
    w = torch.where(gap, (q - q0) / torch.where(gap, q1 - q0, 1.0), 1.0)
    out = v0 + w * (v1 - v0)
    # q at or below the first node: np.interp returns the first value
    out = torch.where(i == 0, ref[:, :1], out)
    return out.reshape(image.shape).to(image.dtype)
