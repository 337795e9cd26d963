"""Whole-scene RGB->NIR synthesis on the device, counterpart of
``nirgan_tpu/inference/scene.py``.

A real Sentinel-2 scene is about 10980² px, and tiles predicted one by one
show seams, since each window's instance-norm statistics and reflect
borders differ.  As in the JAX package:

  * the scene is reflect-padded by ``overlap`` and cut into ``tile``²
    windows on a ``tile - 2·overlap`` stride, so every original pixel lies
    in the full-weight plateau of at least one window;
  * the windows run through the generator in batches (with the int8 trunk
    when the task serves int8, calibrated on the scene's first window
    batch), each window on the SatCLIP routes with the location embedding
    of its own centre (``data/geotiff.pixel_lonlat``);
  * the windows are blended with a separable plateau-cosine weight and
    normalised by the accumulated weight.

The JAX package cut and blended on the host, since its numpy loop throttled
a TPU pipeline.  Here the whole scene lives on the card: the padded scene
(uint16 DN stays uint16) is made there from one copy of the scene, the
windows are slices of it stacked into the NHWC batch, and the weighted sum
and the weight are f32 device tensors to which each window is added in
window order, one ``add_`` each (no ``index_add_``, whose CUDA adds are
atomic, so the result repeats bit for bit).  Only the final crop comes
back.  A tail batch runs at its own size.  Nothing waits for the card
between the first copy and the last, so the host (the tower, the launches)
runs ahead of it.  The CLI is ``nirgan_tpu_torch/synthesize_scene.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nirgan_tpu_torch.data.geotiff import pixel_lonlat

__all__ = ["synthesize_scene", "tile_origins", "plateau_weight", "upload_scene",
           "blend_scene"]


def tile_origins(length: int, tile: int, stride: int) -> list:
    """Window origins covering ``[0, length)``: multiples of ``stride``,
    with the last window clamped flush to the end.  Guarantees the
    full-weight plateaus ``[k·stride + overlap, k·stride + overlap + stride)``
    tile the interior contiguously (see module docstring)."""
    if length <= tile:
        return [0]
    xs = list(range(0, length - tile + 1, stride))
    if xs[-1] != length - tile:
        xs.append(length - tile)
    return xs


def plateau_weight(tile: int, overlap: int) -> np.ndarray:
    """1-D blending weight: half-cosine ramp 0→1 over the first ``overlap``
    samples, flat 1 in the middle, mirrored ramp at the end.  Strictly
    positive everywhere so border windows never divide by zero."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = 0.5 - 0.5 * np.cos(
            np.pi * (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0))
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def _pad_reflect(arr: np.ndarray, pads: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """np.pad(mode='reflect') that tolerates pads ≥ the axis length by
    reflecting in chunks (relevant only for degenerate strip scenes)."""
    while any(p > 0 for pair in pads for p in pair):
        step = tuple((min(b, max(arr.shape[i] - 1, 0)),
                      min(a, max(arr.shape[i] - 1, 0)))
                     for i, (b, a) in enumerate(pads))
        if all(p == 0 for pair in step for p in pair):  # 1-px axis: replicate
            step = tuple((min(b, 1), min(a, 1)) for b, a in pads)
            arr = np.pad(arr, step, mode="edge")
        else:
            arr = np.pad(arr, step, mode="reflect")
        pads = tuple((b - sb, a - sa)
                     for (b, a), (sb, sa) in zip(pads, step))
    return arr


def _scene_pads(height: int, width: int, tile: int,
                overlap: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The reflect pad of each axis: ``overlap`` before, and after at least
    ``overlap`` and enough for one whole window."""
    return ((overlap, max(overlap, tile - height - overlap)),
            (overlap, max(overlap, tile - width - overlap)))


def _check(task, rgb_chw, tile: int, overlap: int) -> np.ndarray:
    """The argument checks of ``nirgan_tpu/inference/scene.py:114-127``;
    returns the scene as an array."""
    if overlap < 0 or tile <= 2 * overlap:
        raise ValueError("need 0 <= overlap < tile/2")
    netg = str(getattr(task, "opt", None) and task.opt.get("netG", ""))
    if netg.startswith("unet"):
        # a UNet bottleneck needs its input divisible by 2^num_downs; the
        # reference's torch UNet fails identically under reflect-pad
        # (model/pix2pix.py:91-108), so UNet serving runs unpadded
        downs = 7 if netg == "unet_128" else 8
        eff = tile + 2 * getattr(task, "pad_amount", 0)
        if eff % (1 << downs):
            raise ValueError(
                f"{netg} needs (tile + 2·padding_amount) divisible by "
                f"{1 << downs}, got {eff} — serve UNets with Data.padding: "
                f"false and a power-of-two tile")
    rgb_chw = np.asarray(rgb_chw)
    if rgb_chw.ndim != 3 or rgb_chw.shape[0] != 3:
        raise ValueError(f"expected (3, H, W) scene, got {rgb_chw.shape}")
    return rgb_chw


def _movable(t: torch.Tensor) -> torch.Tensor:
    """uint16 viewed as int16, the same bytes: slicing, gathers and stacks
    take every 16-bit type, while torch builds few kernels for uint16."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def upload_scene(task, rgb_chw, tile: int = 512, overlap: int = 32) -> torch.Tensor:
    """The (3, H, W) scene on ``task.device``, reflect-padded for the window
    grid (``_pad_reflect`` by ``_scene_pads``) as an (Hp, Wp, 3) tensor:
    uint8/uint16 DN keep their type (scaled on the device), anything else
    becomes f32.  One copy of the scene goes over; the pad is a gather on
    the device by the row and column maps that ``_pad_reflect`` gives an
    index vector, so it equals ``_pad_reflect`` of the scene."""
    rgb_chw = _check(task, rgb_chw, tile, overlap)
    if rgb_chw.dtype not in (np.uint8, np.uint16):
        rgb_chw = np.asarray(rgb_chw, np.float32)
    _, height, width = rgb_chw.shape
    pad_rows, pad_cols = _scene_pads(height, width, tile, overlap)
    rows = _pad_reflect(np.arange(height), (pad_rows,))
    cols = _pad_reflect(np.arange(width), (pad_cols,))
    scene = torch.from_numpy(np.ascontiguousarray(rgb_chw))
    dtype = scene.dtype
    dev = _movable(scene).to(task.device).permute(1, 2, 0)
    padded = dev.index_select(0, torch.from_numpy(rows).to(task.device))
    del dev
    padded = padded.index_select(1, torch.from_numpy(cols).to(task.device))
    return padded.contiguous().view(dtype)


@torch.inference_mode()
def blend_scene(task, padded: torch.Tensor, height: int, width: int, *,
                tile: int = 512, overlap: int = 32, batch_size: int = 8,
                meta: Optional[dict] = None, process_index: Optional[int] = None,
                process_count: Optional[int] = None,
                progress: bool = False) -> Tuple[torch.Tensor, int]:
    """Every window of ``upload_scene``'s padded scene through the bound
    generator, blended: ``(nir (1, rows, width) f32 on the device, row
    offset)``, the whole scene (offset 0) unless ``process_count`` > 1 splits
    it into row bands (see ``synthesize_scene``)."""
    if task.satclip and meta is not None and pixel_lonlat(meta, 0, 0) is None:
        meta = None
    if task.satclip and meta is None:
        raise ValueError("SatCLIP task needs georeferenced `meta` for "
                         "per-window coordinates")
    O, S = overlap, tile - 2 * overlap
    Hp, Wp = padded.shape[0], padded.shape[1]
    ys, xs = tile_origins(Hp, tile, S), tile_origins(Wp, tile, S)
    wins_global = [(y, x) for y in ys for x in xs]

    banded = process_count is not None and process_count > 1
    if banded:
        if not (0 <= process_index < process_count):
            raise ValueError("need 0 <= process_index < process_count")
        # contiguous padded-row bands; every window that touches the band is
        # computed here (halo recompute, no communication)
        bounds = [round(i * Hp / process_count)
                  for i in range(process_count + 1)]
        lo, hi = bounds[process_index], bounds[process_index + 1]
        wins = [(y, x) for y in ys if y < hi and y + tile > lo for x in xs]
    else:
        lo, hi = 0, Hp
        wins = wins_global

    device = padded.device
    w1d = plateau_weight(tile, O)
    # the stager's copy: a plain one would wait for the card to drain
    w2d = task.stager.to_device([np.outer(w1d, w1d)])[0]
    num = torch.zeros((Hp, Wp), dtype=torch.float32, device=device)
    den = torch.zeros((Hp, Wp), dtype=torch.float32, device=device)
    scene = _movable(padded)

    def window_coords(batch_wins) -> np.ndarray:
        out = []
        for (y, x) in batch_wins:
            # window centre in ORIGINAL pixel coordinates, clipped into the
            # scene (padding reflects border content, so its centroid is
            # the nearest real location)
            r = min(max(y - O + tile / 2.0, 0.0), height - 1.0)
            c = min(max(x - O + tile / 2.0, 0.0), width - 1.0)
            out.append(pixel_lonlat(meta, r, c))
        return np.stack(out).astype(np.float32)

    def make_batch(batch_wins) -> dict:
        """The generator's input of these windows: {"rgb"} NHWC in the
        compute dtype [, "embeds"]."""
        tiles = torch.stack([scene[y:y + tile, x:x + tile] for (y, x) in batch_wins])
        cond = {"rgb": tiles.view(padded.dtype)}
        if task.satclip:
            cond.update(task.condition(cond["rgb"], None,
                                       task._embed(window_coords(batch_wins))))
        cond["rgb"] = task._dn_to_reflectance(cond["rgb"], task.compute_dtype)
        return cond

    trunk_q = None
    if task.wants_int8_serving() and wins:
        trunk_q = task.kept_trunk_q()
        if trunk_q is None:
            # calibrate on the GLOBAL first window batch, identical in every
            # band, so banded runs derive ONE shared quantised trunk
            first = make_batch(wins_global[:batch_size])
            trunk_q = task.trunk_q_for(first["rgb"], first.get("embeds"))

    for i in range(0, len(wins), batch_size):
        batch_wins = wins[i:i + batch_size]
        cond = make_batch(batch_wins)
        pred = task.g_apply(cond["rgb"], cond.get("embeds"), trunk_q).float()[..., 0]
        weighted = pred * w2d
        for k, (y, x) in enumerate(batch_wins):
            num[y:y + tile, x:x + tile].add_(weighted[k])
            den[y:y + tile, x:x + tile].add_(w2d)
        if progress:
            print(f"\r  windows {min(i + batch_size, len(wins))}/{len(wins)}",
                  end="", flush=True)
    if progress:
        print()

    if banded:
        a2, b2 = max(lo, O), min(hi, O + height)
        if b2 <= a2:  # band entirely inside the padding margin
            return torch.zeros((1, 0, width), dtype=torch.float32, device=device), 0
        band = num[a2:b2, O:O + width] / den[a2:b2, O:O + width]
        return band[None], a2 - O
    return (num[O:O + height, O:O + width] / den[O:O + height, O:O + width])[None], 0


def synthesize_scene(task, rgb_chw: np.ndarray, *, tile: int = 512,
                     overlap: int = 32, batch_size: int = 8,
                     meta: Optional[dict] = None,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     progress: bool = False):
    """Synthesize the NIR band of one whole scene on ``task.device``.

    ``task``: a ``Px2PxTask`` with its weights bound.
    ``rgb_chw``: (3, H, W): float reflectance, or uint8/uint16 DN (kept
    integer through the copy to the device, scaled there).
    ``meta``: ``data.geotiff.read_geotiff`` metadata for the per-window
    SatCLIP coordinates; required when the task has a SatCLIP route.

    With ``process_index``/``process_count`` set, this process takes a
    contiguous row band of the padded scene and computes every window that
    touches the band; boundary windows are recomputed by both neighbours,
    so the bands need no communication and each owned row equals the
    single-process result.  int8 calibration uses the global first window
    batch, so every process derives the same quantised trunk.  Returns
    ``(band (1, rows, W) float32, row_offset)`` in original scene
    coordinates; the bands of all processes are disjoint and tile
    ``[0, H)``.

    Without ``process_count`` (or 1): returns (1, H, W) float32 NIR."""
    padded = upload_scene(task, rgb_chw, tile, overlap)
    _, height, width = np.shape(rgb_chw)
    nir, offset = blend_scene(task, padded, height, width, tile=tile,
                              overlap=overlap, batch_size=batch_size, meta=meta,
                              process_index=process_index,
                              process_count=process_count, progress=progress)
    del padded
    out = nir.cpu().numpy()
    if process_count is not None and process_count > 1:
        return out, offset
    return out
