"""Plain bulk serving of 512^2 tiles, after the upstream
``create_synthetic_dataset.py``: DN / dn_scale, the padded generator
forward, the S2 NIR upsampled x4 bilinearly (then resized to the tile, the
upstream double interpolation) as the template, ``skimage``'s histogram
matching, and the fp16 cast."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import pix2pix


def match_histogram(source: np.ndarray, template: np.ndarray) -> np.ndarray:
    """``skimage.exposure.match_histograms`` on one channel: every source
    value takes the template value interpolated at its cumulative
    quantile (``_match_cumulative_cdf``), in float64."""
    values, inverse, counts = np.unique(source.ravel(), return_inverse=True,
                                        return_counts=True)
    t_values, t_counts = np.unique(template.ravel(), return_counts=True)
    q = np.cumsum(counts) / source.size
    t_q = np.cumsum(t_counts) / template.size
    return np.interp(q, t_q, t_values)[inverse].reshape(source.shape)


def serve(p: dict, hr: np.ndarray, s2: np.ndarray, cfg: dict,
          a: pix2pix.Arith = pix2pix.PLAIN, device="cuda", chunk: int = 4,
          embeds=None, trunk=None) -> np.ndarray:
    """hr (N, 3, H, W) and s2 (N, 1, h, w) uint16 DN -> (N, 1, H, W)
    float16 NIR (``trunk``: the generator's residual trunk, as
    ``pix2pix.generator`` takes it).  The tiles must be square at a shape
    bucket, so no bucket padding applies."""
    dn = float(cfg["Data"].get("dn_scale", 10000.0))
    n, _, hh, ww = hr.shape
    buckets = cfg.get("tpu", {}).get("shape_buckets", [256, 512])
    if hh != ww or hh not in buckets:
        raise ValueError(f"the reference serves square bucket tiles, not {hh}x{ww}")
    out = np.empty((n, 1, hh, ww), np.float16)
    for i in range(0, n, chunk):
        x = torch.from_numpy(hr[i:i + chunk].astype(np.float32)).to(device) / dn
        e = None if embeds is None else embeds[i:i + chunk].to(device)
        with torch.no_grad():
            pred = pix2pix.g_apply(p, x, cfg, a, e, trunk).double().cpu().numpy()
        t = torch.from_numpy(s2[i:i + chunk].astype(np.float32)) / dn
        up = F.interpolate(t, size=(t.shape[2] * 4, t.shape[3] * 4), mode="bilinear",
                           align_corners=False)
        if up.shape[2:] != (hh, ww):
            up = F.interpolate(up, size=(hh, ww), mode="bilinear", align_corners=False)
        for j in range(pred.shape[0]):
            out[i + j, 0] = match_histogram(pred[j, 0], up[j, 0].double().numpy())
    return out


def worst_rel_rmse(got: np.ndarray, want: np.ndarray) -> float:
    """The largest, over the tiles, root mean square of got - want over
    the spread of want (its deviation from its own mean)."""
    worst = 0.0
    for g, w in zip(got.astype(np.float64), want.astype(np.float64)):
        spread = np.sqrt(np.mean(np.square(w - w.mean())))
        worst = max(worst, float(np.sqrt(np.mean(np.square(g - w))) / max(spread, 1e-12)))
    return worst
