"""Offline results table, counterpart of
``nirgan_tpu/validation/results_table.py`` (reference
``validation_utils/get_results_table.py``): load a config and its weights,
sweep a validation dataset into the per-sample metric GeoJSON on the
task's device, and emit the radar comparison plots for SatCLIP vs
no-SatCLIP runs.

Weights: a reference Lightning ``.ckpt`` / ``.pt`` / ``.pth`` (``netG.*``
keys, mapped by ``weights.load_reference_weights``), or the port's own
checkpoints: a run directory (its ``best.pt``, else ``last.pt``, as the
JAX package prefers ``best``) or one of those files.  A ``.pt`` file is
told apart by what it holds.  The JAX package's orbax directories need
jax and raise here.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

__all__ = ["create_val_metrics", "filter_for_countries", "run_comparison"]


def _generator_weights(task, path: str):
    """The generator's state_dict in ``path``, a checkpoint of the port's
    ``CheckpointManager`` (``"G"`` and ``"step"``) or a reference file
    (``"state_dict"`` or ``netG.*`` keys); None when a reference file holds
    no generator.  Anything else raises."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(blob, dict):
        raise ValueError(f"{path}: not a checkpoint (a {type(blob).__name__})")
    if "G" in blob and "step" in blob:
        return blob["G"]
    if "state_dict" in blob or any(str(k).startswith("netG.") for k in blob):
        return task.load_torch_weights(path).get("netG")
    raise ValueError(f"{path}: neither a checkpoint of the port's trainer "
                     "('G', 'step') nor a reference one ('state_dict' or "
                     f"netG.* keys); it holds {sorted(map(str, blob))[:8]}")


def create_val_metrics(config_path: str, folder: str, dataset=None,
                       weights_path: str | None = None, max_samples=None,
                       quant: str | None = None, device="cuda"):
    """One model sweep → CSV + context GeoJSON in ``folder``, on ``device``
    (the card unless the caller asks for the CPU).

    ``quant`` overrides ``tpu.serving_quant`` — sweeping the same weights
    with ``none`` vs ``int8`` is the operator's offline quality check for
    enabling the quantised serving mode."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data.select_dataset import dataset_selector
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train.checkpoint import merge_state_dict, run_checkpoint
    from nirgan_tpu_torch.validation.spider import spider_validation_callback

    config = load_config(config_path)
    if quant is not None:
        # reference-schema configs have no tpu: section — create it
        config["tpu"] = config.get("tpu") or {}
        config.tpu.serving_quant = quant
    task = Px2PxTask(config, device=device, seed=0)
    wp = weights_path or config.custom_configs.Model.get("weights_path")
    if wp and os.path.exists(wp):
        path = run_checkpoint(wp)
        loaded = _generator_weights(task, path)
        if loaded is not None:
            merge_state_dict(task.netG, loaded)
            print("Loaded (only) Weights from:", path)

    if dataset is None:
        dataset = dataset_selector(config).val_ds
    return spider_validation_callback(task, dataset, satclip=task.satclip,
                                      folder=folder, epoch_no=0,
                                      max_samples=max_samples)


def filter_for_countries(df, world_path: str):
    """Inner spatial filter: keep only samples whose (x, y) falls inside a
    polygon of the countries layer (reference ``get_results_table.py:149-152``
    drops ocean/Antarctica points before the radar plots).  Uses geopandas
    when installed, else the built-in point-in-polygon join for GeoJSON."""
    try:
        import geopandas as gpd

        gdf = gpd.GeoDataFrame(df, geometry=gpd.points_from_xy(df.x, df.y),
                               crs="EPSG:4326")
        world = gpd.read_file(world_path)
        import pandas as pd

        return pd.DataFrame(gpd.sjoin(gdf, world, how="inner"))
    except ImportError:
        import json

        from nirgan_tpu_torch.validation.geo_ablation import _geom_contains

        with open(world_path) as f:
            feats = json.load(f).get("features", [])
        keep = [
            any(_geom_contains(ft["geometry"], float(x), float(y)) for ft in feats)
            for x, y in zip(df.x, df.y)
        ]
        return df[np.asarray(keep)].reset_index(drop=True)


def run_comparison(satclip_config: str, plain_config: str, dataset=None,
                   out_root: str = "validation_metrics", max_samples=None,
                   satclip_weights: str | None = None,
                   plain_weights: str | None = None, device="cuda"):
    """Both sweeps + the three radar comparisons (Continent / Köppen /
    economy), mirroring the reference's main flow (``:155-183``).
    ``*_weights`` may each be a reference .ckpt/.pt or a run directory of
    the port's trainer."""
    from nirgan_tpu_torch.validation.spiders import (
        plot_radar_comparison,
        read_metric_geojson,
    )

    folder = os.path.join(out_root,
                          datetime.datetime.now().strftime("%d_%m_%Y_%H_%M_%S"))
    os.makedirs(folder, exist_ok=True)
    create_val_metrics(plain_config, folder, dataset=dataset,
                       weights_path=plain_weights, max_samples=max_samples,
                       device=device)
    nosc = os.path.join(folder, "validation_metrics_ablation_satclip_False_e0.geojson")
    create_val_metrics(satclip_config, folder, dataset=dataset,
                       weights_path=satclip_weights, max_samples=max_samples,
                       device=device)
    sc = os.path.join(folder, "validation_metrics_ablation_satclip_True_e0.geojson")

    gdf_sc, gdf_nosc = read_metric_geojson(sc), read_metric_geojson(nosc)
    outs = []
    for dt in ("Continent", "Koppen_Class", "economy"):
        try:
            outs.append(plot_radar_comparison(gdf_sc, gdf_nosc, dt, folder=folder))
        except Exception as e:
            print(f"radar {dt} skipped:", e)
    return folder, outs
