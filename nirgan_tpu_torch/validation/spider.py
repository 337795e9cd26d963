"""Per-epoch geographic validation sweep, counterpart of
``nirgan_tpu/validation/spider.py`` (reference
``validation_utils/spider_validation_callback.py:13-99``): predict over the
validation dataset, compute per-sample metrics on a center crop of 240,
save the CSV and an example panel every ``plot_every`` samples, and write a
GeoJSON with country / continent / economy / Köppen context for the radar
plots.

As in the JAX package the sweep runs at a batch of ``batch_size`` with the
batched per-sample metric program, not at batch 1.  Each batch goes
through the task's ``predict_step`` (on the task's device, with its
kernels), is cropped on the host, goes back to the device through the
task's stager for ``per_sample_metrics``, and its (B,) metric vectors come
back in one copy.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from nirgan_tpu_torch.data.pipeline import Loader
from nirgan_tpu_torch.validation.geo_ablation import (
    append_info_to_df,
    clean_economy,
    points_to_geojson,
)
from nirgan_tpu_torch.validation.per_sample_metrics import per_sample_metrics
from nirgan_tpu_torch.validation.val_utils import crop_center

__all__ = ["spider_validation_callback"]

METRIC_COLUMNS = ["ssim", "psnr", "l1", "l2", "l1_ndvi", "l1_ndwi", "l1_evi"]


def _metrics(task, rgb_c: np.ndarray, nir_c: np.ndarray,
             pred_c: np.ndarray) -> np.ndarray:
    """(len(METRIC_COLUMNS), B) per-sample metrics of NCHW host crops,
    computed on the task's device."""
    rgb, nir, pred = (t.permute(0, 2, 3, 1) for t in task.stager.to_device(
        [rgb_c, nir_c, pred_c]))
    m = per_sample_metrics(rgb, nir, pred)
    return task.stager.to_host(torch.stack([m[k] for k in METRIC_COLUMNS])).result()


def spider_validation_callback(task, ds, satclip: bool, folder: str,
                               epoch_no: int = 0, batch_size: int = 8,
                               crop: int = 240, plot_every: int = 50,
                               max_samples: int | None = None,
                               world_path: str | None = None,
                               koppen_path: str | None = None,
                               koppen_legend: str | None = None) -> pd.DataFrame:
    os.makedirs(folder, exist_ok=True)
    rows = {k: [] for k in ["id", "x", "y"] + METRIC_COLUMNS}
    loader = Loader(ds, batch_size, shuffle=False, drop_last=False)

    sample_id = 0
    for batch in loader:
        rgb = np.asarray(batch["rgb"], np.float32)
        nir = np.asarray(batch["nir"], np.float32)
        coords = np.asarray(batch.get("coords", np.zeros((len(rgb), 2))), np.float32)
        pred = task.predict_step(rgb, coords if satclip else None)

        c = min(crop, rgb.shape[-1], rgb.shape[-2])
        rgb_c = np.stack([crop_center(im, c) for im in rgb])
        nir_c = np.stack([crop_center(im, c) for im in nir])
        pred_c = np.stack([crop_center(im, c) for im in pred])
        m = dict(zip(METRIC_COLUMNS, _metrics(task, rgb_c, nir_c, pred_c)))

        for i in range(len(rgb)):
            rows["id"].append(sample_id)
            rows["x"].append(float(coords[i][0]))
            rows["y"].append(float(coords[i][1]))
            for k in METRIC_COLUMNS:
                rows[k].append(float(m[k][i]))

            if sample_id % plot_every == 0:
                _save_example(rgb_c[i], nir_c[i], pred_c[i], sample_id,
                              satclip, folder)
            sample_id += 1
        if max_samples is not None and sample_id >= max_samples:
            break

    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(folder, "validation_metrics.csv"))

    # unset layer paths resolve to the shipped coarse layers (env-overridable)
    # so the ablation grouping works out of the box — layers/__init__.py
    if world_path is None:
        from nirgan_tpu_torch.validation.layers import default_world_path

        world_path = default_world_path()
    if koppen_path is None:
        from nirgan_tpu_torch.validation.layers import default_koppen_paths

        koppen_path, koppen_legend = default_koppen_paths()
    gdf = append_info_to_df(df, world_path=world_path, koppen_path=koppen_path,
                            koppen_legend=koppen_legend)
    gdf = clean_economy(gdf)
    gdf = gdf.loc[:, ~gdf.columns.duplicated()]
    out = os.path.join(
        folder, f"validation_metrics_ablation_satclip_{satclip}_e{epoch_no}.geojson")
    points_to_geojson(gdf, out)
    return gdf


def _save_example(rgb_chw, nir_chw, pred_chw, sample_id: int, satclip: bool,
                  folder: str):
    try:
        from nirgan_tpu_torch.utils.logging_helpers import plot_tensors

        image_folder = os.path.join(folder, "images")
        os.makedirs(image_folder, exist_ok=True)
        tag = "SatCLIP" if satclip else "NoSatCLIP"
        img = plot_tensors(rgb_chw[None], nir_chw[None], pred_chw[None])
        img.save(os.path.join(
            image_folder, f"example_image_{str(sample_id).zfill(4)}_{tag}.png"), "PNG")
    except Exception as e:
        print("spider example plot failed:", e)
