"""Plain whole-scene serving, after the upstream tiled inference of NIR-GAN
scenes: the scene reflect-padded by ``overlap`` (and to at least one
window), cut into ``tile``^2 windows on a ``tile - 2 overlap`` stride (the
last window flush with the end), each window through the padded generator
with the SatCLIP embedding of its centre (clipped into the scene), and
blended by a separable plateau-cosine weight normalised by the summed
weight."""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference import pix2pix, satclip


def tile_origins(length: int, tile: int, stride: int) -> list:
    if length <= tile:
        return [0]
    xs = list(range(0, length - tile + 1, stride))
    if xs[-1] != length - tile:
        xs.append(length - tile)
    return xs


def plateau(tile: int, overlap: int) -> np.ndarray:
    """0 -> 1 over ``overlap`` samples by a half cosine, 1, and back."""
    w = np.ones(tile, np.float64)
    if overlap > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 1.0) / (overlap + 1.0))
        w[:overlap], w[-overlap:] = ramp, ramp[::-1]
    return w


def window_lonlat(meta: dict, y: int, x: int, tile: int, overlap: int, height: int,
                  width: int) -> np.ndarray:
    """The (lon, lat) of a window's centre pixel, in float32 degrees."""
    r = min(max(y - overlap + tile / 2.0, 0.0), height - 1.0)
    c = min(max(x - overlap + tile / 2.0, 0.0), width - 1.0)
    sx, sy = meta["pixel_scale"]
    ox, oy = meta["tiepoint"][3], meta["tiepoint"][4]
    lon, lat = satclip.utm_to_lonlat(meta["epsg"], ox + (c + 0.5) * sx, oy - (r + 0.5) * sy)
    return np.array([lon, lat], np.float32)


def pads(h: int, w: int, tile: int, overlap: int) -> tuple:
    """The reflect pad of a (3, h, w) scene."""
    return ((0, 0), (overlap, max(overlap, tile - h - overlap)),
            (overlap, max(overlap, tile - w - overlap)))


def windows(h: int, w: int, tile: int, overlap: int) -> list:
    """The (y, x) origins of the windows in the padded scene, row by row."""
    _, (t, b), (l, r) = pads(h, w, tile, overlap)
    stride = tile - 2 * overlap
    return [(y, x) for y in tile_origins(h + t + b, tile, stride)
            for x in tile_origins(w + l + r, tile, stride)]


def window_embeddings(meta: dict, h: int, w: int, tower: list, tile: int, overlap: int,
                      dtype=np.float64) -> np.ndarray:
    """(windows, embed) float32: each window's SatCLIP embedding, in the
    order of ``windows``; ``dtype`` is the tower's arithmetic."""
    ll = np.stack([window_lonlat(meta, y, x, tile, overlap, h, w)
                   for y, x in windows(h, w, tile, overlap)])
    return satclip.embed(tower, ll, dtype)


def scene(p: dict, rgb: np.ndarray, meta: dict, cfg: dict, tower: list, tile: int,
          overlap: int, a: pix2pix.Arith = pix2pix.PLAIN, device="cuda",
          chunk: int = 4) -> np.ndarray:
    """(3, H, W) uint16 DN -> (H, W) float32 NIR."""
    dn = float(cfg["Data"].get("dn_scale", 10000.0))
    _, h, w = rgb.shape
    padded = np.pad(rgb, pads(h, w, tile, overlap), mode="reflect")
    wins = windows(h, w, tile, overlap)
    w1 = plateau(tile, overlap)
    w2 = torch.from_numpy(np.outer(w1, w1)).to(device)
    num = torch.zeros(padded.shape[1:], dtype=torch.float64, device=device)
    den = torch.zeros_like(num)
    for i in range(0, len(wins), chunk):
        part = wins[i:i + chunk]
        x = np.stack([padded[:, y:y + tile, x0:x0 + tile] for y, x0 in part])
        x = torch.from_numpy(x.astype(np.float32)).to(device) / dn
        ll = np.stack([window_lonlat(meta, y, x0, tile, overlap, h, w) for y, x0 in part])
        e = torch.from_numpy(satclip.embed(tower, ll)).to(device)
        with torch.no_grad():
            pred = pix2pix.g_apply(p, x, cfg, a, e)[:, 0].double()
        for k, (y, x0) in enumerate(part):
            num[y:y + tile, x0:x0 + tile] += pred[k] * w2
            den[y:y + tile, x0:x0 + tile] += w2
    out = num[overlap:overlap + h, overlap:overlap + w] / den[overlap:overlap + h,
                                                               overlap:overlap + w]
    return out.float().cpu().numpy()

