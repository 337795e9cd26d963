"""Radar ("spider") comparison plots, the port's own copy of
``nirgan_tpu/validation/spiders.py``: SatCLIP vs no-SatCLIP metric means per
Continent / Köppen class / economy group (reference
``validation_utils/plot_val_spiders.py:12-87``), plus a batch run over a
folder of per-epoch GeoJSONs (``:94-125``).

GeoJSON reading works without geopandas (plain json → DataFrame).  The
plots are matplotlib's (Agg) where it is installed, else drawn with PIL
(``utils/pil_plots.radar_panels``): the same groups, means and file names.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pandas as pd

__all__ = ["read_metric_geojson", "plot_radar_comparison", "plot_epoch_folder"]

KOPPEN_LABELS = {
    "A": "Tropical", "B": "Arid", "C": "Temperate",
    "D": "Continental", "E": "Polar", "U": "Undetermined",
}


def read_metric_geojson(path: str) -> pd.DataFrame:
    try:
        import geopandas as gpd

        return pd.DataFrame(gpd.read_file(path).drop(columns="geometry"))
    except Exception:
        with open(path) as f:
            fc = json.load(f)
        rows = []
        for feat in fc["features"]:
            row = dict(feat["properties"])
            row["x"], row["y"] = feat["geometry"]["coordinates"]
            rows.append(row)
        return pd.DataFrame(rows)


def plot_radar_comparison(sc: pd.DataFrame, no_sc: pd.DataFrame, data_type: str,
                          out_name: str = "", folder: str = "validation_plots",
                          metrics=("psnr", "ssim"),
                          labels=("SatCLIP", "No SatCLIP")) -> str:
    """Two polar charts (one per metric), categories = group values.
    Returns the output file path."""
    df1, df2 = sc.copy(), no_sc.copy()
    if data_type == "Koppen_Class":
        df1 = df1[df1["Koppen_Class"] != "U"]
        df2 = df2[df2["Koppen_Class"] != "U"]
        df1["Koppen_Class"] = df1["Koppen_Class"].replace(KOPPEN_LABELS)
        df2["Koppen_Class"] = df2["Koppen_Class"].replace(KOPPEN_LABELS)

    stats1 = df1.groupby(data_type).agg({m: "mean" for m in metrics}).reset_index()
    stats2 = df2.groupby(data_type).agg({m: "mean" for m in metrics}).reset_index()
    cats = stats1[data_type].tolist()
    n = len(cats)
    if n == 0:
        raise ValueError(f"no categories for {data_type}")
    angles = [i / n * 2 * np.pi for i in range(n)] + [0.0]
    series = [[stats1[m].tolist() for m in metrics],
              [[float(stats2.loc[stats2[data_type] == c, m].mean())
                if (stats2[data_type] == c).any() else np.nan for c in cats]
               for m in metrics]]

    os.makedirs(folder, exist_ok=True)
    suffix = f"_{out_name}" if out_name else ""
    out = os.path.join(folder,
                       f"metrics_radar_satclip{suffix}_{data_type}.png".replace(" ", "_"))
    try:
        import matplotlib
    except ImportError:
        from nirgan_tpu_torch.utils.pil_plots import radar_panels

        radar_panels(cats, list(metrics), series, labels).save(out)
        return out

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(metrics), figsize=(6 * len(metrics), 6),
                             subplot_kw=dict(polar=True))
    axes = np.atleast_1d(axes)
    for ax, metric, v1, v2 in zip(axes, metrics, *series):
        ax.set_xticks(angles[:-1])
        ax.set_xticklabels(cats, color="grey", size=13)
        ax.set_title(metric.upper(), size=15)
        ax.plot(angles, v1 + v1[:1], linewidth=2, linestyle="solid", label=labels[0])
        ax.plot(angles, v2 + v2[:1], linewidth=2, linestyle="dashed", label=labels[1])
        ax.legend(loc="upper right", bbox_to_anchor=(0.1, 0.1))

    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_epoch_folder(folder: str, baseline_geojson: str, out_folder: str,
                      data_types=("Continent", "Koppen_Class", "economy")):
    """Iterate ``*_e{N}.geojson`` files in a run folder and emit radar plots
    against a fixed no-SatCLIP baseline (reference ``:94-125``)."""
    paths = sorted(p for p in os.listdir(folder)
                   if p.endswith((".geojson", ".json")))
    base = read_metric_geojson(baseline_geojson)
    outs = []
    for p in paths:
        m = re.search(r"_e(\d+)\.geojson$", p)
        if not m:
            continue
        tag = f"E{int(m.group(1)):03d}"
        df = read_metric_geojson(os.path.join(folder, p))
        for dt in data_types:
            try:
                outs.append(plot_radar_comparison(df, base, dt, out_name=tag,
                                                  folder=out_folder))
            except Exception as e:
                print(f"radar plot {dt}/{tag} skipped:", e)
    return outs
