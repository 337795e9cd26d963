"""NDVI time-series validation, counterpart of
``nirgan_tpu/validation/time_series.py`` (reference
``validation_utils/time_series_validation.py``): predict NIR over a dated
stack of Sentinel-2 tiles of one location, track the mean NDVI of a center
patch through time for real vs predicted NIR, and render a timeline plot
with sample panels.

File contract: a glob of ``*.tif`` (or ``.npz``) whose names carry
``<anything>_<YYYYMMDD>T...`` timestamps; files with "SKIP" in the stem are
ignored (reference ``:36-44``).  Raster reading is gated on
rasterio when installed, else the port's reader (data/geotiff.py); ``.npz``
stacks always work.  With a model (a task of the port), each tile is
predicted by its ``predict_step`` on the task's device; without one,
predicted NIR falls back to ``nir * 1.15`` — the reference's fake-data test
path (``:91``).  The plot needs matplotlib.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

__all__ = ["get_pred_nirs_and_info", "plot_timeline", "calculate_and_plot_timeline"]


def _read_stack(path: str):
    if path.endswith(".npz"):
        z = np.load(path)
        img = z[list(z.files)[0]]
        return np.asarray(img), None
    try:
        import rasterio
        from rasterio.warp import transform as rio_transform

        with rasterio.open(path) as src:
            img = src.read()
            cx, cy = src.transform * (src.width // 2, src.height // 2)
            lon, lat = cx, cy
            if src.crs and src.crs.to_epsg() != 4326:
                lon, lat = (v[0] for v in rio_transform(src.crs, "EPSG:4326",
                                                        [cx], [cy]))
            return img, (lon, lat)
    except ImportError:
        pass
    from nirgan_tpu_torch.data.geotiff import centroid_lonlat, read_geotiff

    img, meta = read_geotiff(path)
    ll = centroid_lonlat(meta)
    return img, (float(ll[0]), float(ll[1])) if ll is not None else None


def get_pred_nirs_and_info(model=None, root_dir: str = "", size_input: int = 256,
                           coords_fallback=(0.0, 0.0)):
    """→ (rgbs (T,3,s,s), nirs (T,1,s,s), nir_preds (T,1,s,s), timestamps)."""
    files = sorted(glob.glob(root_dir))
    rgbs, nirs, preds, stamps = [], [], [], []
    for path in files:
        stem = os.path.basename(path).split(".")[0]
        if "SKIP" in stem:
            continue
        parts = stem.split("_")
        date = parts[1].split("T")[0] if len(parts) > 1 else stem
        img, lonlat = _read_stack(path)
        h, w = img.shape[1], img.shape[2]
        half = size_input // 2
        cy, cx = h // 2, w // 2
        tile = img[:, max(cy - half, 0):cy + half, max(cx - half, 0):cx + half]
        tile = np.nan_to_num(tile.astype(np.float32), nan=0.0, posinf=0.0,
                             neginf=0.0) / 10000.0
        rgb, nir = tile[:3], tile[3:4]
        if model is not None:
            coords = np.asarray([lonlat if lonlat else coords_fallback], np.float32)
            pred = model.predict_step(rgb[None],
                                      coords if getattr(model, "satclip", False) else None)[0]
        else:
            pred = nir * 1.15  # fake data for testing (reference :91)
        rgbs.append(rgb), nirs.append(nir), preds.append(pred), stamps.append(date)
    return (np.stack(rgbs), np.stack(nirs), np.stack(preds), stamps)


def _patch_mean_ndvi(rgb, nir, patch: int):
    h, w = nir.shape[-2:]
    y, x = h // 2 - patch // 2, w // 2 - patch // 2
    red = rgb[0, y:y + patch, x:x + patch]
    n = nir[0, y:y + patch, x:x + patch]
    return float(np.mean((n - red) / (n + red + 1e-6)))


def plot_timeline(rgbs, nirs, nir_preds, timestamps, mean_patch_size: int = 32):
    """Timeline of center-patch mean NDVI (real vs predicted) + a row of up
    to 6 RGB sample panels; returns a PIL image (reference ``:120-215``):
    JAX's matplotlib figure, or where matplotlib is not installed the same
    chart and panels drawn with PIL."""
    from nirgan_tpu_torch.utils.pil_plots import has_matplotlib

    ndvi_real = [_patch_mean_ndvi(r, n, mean_patch_size) for r, n in zip(rgbs, nirs)]
    ndvi_pred = [_patch_mean_ndvi(r, p, mean_patch_size) for r, p in zip(rgbs, nir_preds)]
    labels = ["NDVI (real NIR)", "NDVI (predicted NIR)"]
    t = len(timestamps)
    n_show = min(6, t)
    show_idx = np.linspace(0, t - 1, n_show).astype(int)
    panels = [np.clip(np.transpose(rgbs[i], (1, 2, 0)) * 3, 0, 1) for i in show_idx]
    if not has_matplotlib():
        from PIL import Image

        from nirgan_tpu_torch.utils.pil_plots import image_grid, line_chart, stack, unit_rgb

        chart = line_chart([ndvi_real, ndvi_pred], labels, x_names=list(timestamps),
                           ylabel="mean NDVI (center patch)", size=(1200, 420),
                           markers=True)
        row = image_grid([[unit_rgb(p) for p in panels]],
                         [timestamps[i] for i in show_idx])
        return stack([Image.fromarray(chart), row])

    import io

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    fig = plt.figure(figsize=(16, 7))
    gs = fig.add_gridspec(2, max(n_show, 1), height_ratios=[2, 1])
    ax = fig.add_subplot(gs[0, :])
    ax.plot(range(t), ndvi_real, "-o", label=labels[0])
    ax.plot(range(t), ndvi_pred, "-s", label=labels[1])
    ax.set_xticks(range(t))
    ax.set_xticklabels(timestamps, rotation=45, fontsize=8)
    ax.set_ylabel("mean NDVI (center patch)")
    ax.legend()
    for j, i in enumerate(show_idx):
        axi = fig.add_subplot(gs[1, j])
        axi.imshow(panels[j])
        axi.set_title(timestamps[i], fontsize=8)
        axi.axis("off")
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    buf.seek(0)
    img = Image.open(buf).copy()
    plt.close(fig)
    return img


def calculate_and_plot_timeline(model=None, device=None, root_dir: str = "",
                                size_input: int = 256, mean_patch_size: int = 4):
    """End-to-end: read stack → predict → timeline PIL image (the hook the
    trainer's epoch-end logging calls, reference ``model/pix2pix.py:352-358``).
    ``device`` names the device the model's task runs on (None: any);
    a task on another device raises."""
    if model is not None and device is not None:
        want, have = torch.device(device), torch.device(model.device)
        if want.type != have.type or (None not in (want.index, have.index)
                                      and want.index != have.index):
            raise ValueError(f"device {device!r}: the model's task runs on "
                             f"{model.device}")
    rgbs, nirs, preds, stamps = get_pred_nirs_and_info(
        model=model, root_dir=root_dir, size_input=size_input)
    return plot_timeline(rgbs, nirs, preds, stamps, mean_patch_size=mean_patch_size)
