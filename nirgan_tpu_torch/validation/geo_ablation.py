"""Geographic context joins for per-sample validation metrics, the port's
own copy of ``nirgan_tpu/validation/geo_ablation.py`` (reference
``validation_utils/geo_ablation.py``): attach country / continent
/ economy (vector join) and Köppen climate class (raster point query) to a
metric table, then clean the economy labels.

Backend selection: geopandas / rasterstats are used when installed (the
reference's stack).  Without them the joins still run for the common data
formats: a built-in ray-casting point-in-polygon join for GeoJSON country
layers (Polygon/MultiPolygon with holes), and a point query through
the port's ``data/geotiff.py`` for EPSG:4326 Köppen rasters.  Only when no
layer file is available at all do the columns fall back to "Unknown" so
downstream radar plots still work.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import pandas as pd

__all__ = ["append_info_to_df", "clean_economy", "points_to_geojson"]

ECONOMY_CLASSES = {
    1: "Developed: G7",
    2: "Developed: Non G7",
    3: "Emerging: BRIC",
    4: "Emerging: MIKT",
    5: "Emerging: G20",
    6: "Developing",
    7: "Least Developed",
}


def clean_economy(df: pd.DataFrame) -> pd.DataFrame:
    """Map Natural-Earth 'ECONOMY' strings ("1. Developed region: G7", …) to
    the seven display classes (reference ``geo_ablation.py:76-103``)."""
    out = []
    for v in df.get("ECONOMY", pd.Series([None] * len(df))):
        num = int(v[0]) if isinstance(v, str) and v[:1].isdigit() else 999
        out.append(ECONOMY_CLASSES.get(num, "Unknown"))
    df = df.copy()
    df["economy"] = out
    if "ECONOMY" in df.columns:
        df = df.drop(columns=["ECONOMY"])
    return df


def append_info_to_df(df: pd.DataFrame,
                      world_path: Optional[str] = None,
                      koppen_path: Optional[str] = None,
                      koppen_legend: Optional[str] = None) -> pd.DataFrame:
    """Add Country / Continent / ECONOMY / Koppen_Class columns from the
    sample x/y (lon/lat) columns.  Falls back to "Unknown" columns when the
    geo stack or data layers are missing."""
    df = df.copy()
    joined = False
    if world_path and os.path.exists(world_path):
        try:
            import geopandas as gpd

            gdf = gpd.GeoDataFrame(df, geometry=gpd.points_from_xy(df.x, df.y),
                                   crs="EPSG:4326")
            world = gpd.read_file(world_path)
            world = world.rename(columns={"SOV_A3": "Country",
                                          "CONTINENT": "Continent"})
            world = world[["Country", "Continent", "ECONOMY", "geometry"]]
            df = pd.DataFrame(gpd.sjoin(gdf, world.set_crs("EPSG:4326"), how="left"))
            joined = True
        except ImportError:
            if world_path.lower().endswith((".geojson", ".json")):
                df = _pip_join(df, world_path)
                joined = True
        except Exception as e:
            print("country join unavailable:", e)
    if not joined:
        df["Country"] = "Unknown"
        df["Continent"] = "Unknown"
        df["ECONOMY"] = None

    df["Koppen_Class"] = _koppen_classes(df, koppen_path, koppen_legend)
    return df


def _ring_contains(ring: np.ndarray, x: float, y: float) -> bool:
    """Ray casting (even-odd) for one ring of (N, 2) lon/lat vertices."""
    xs, ys = ring[:, 0], ring[:, 1]
    x1, y1 = xs, ys
    x2, y2 = np.roll(xs, -1), np.roll(ys, -1)
    crosses = ((y1 > y) != (y2 > y))
    with np.errstate(divide="ignore", invalid="ignore"):
        x_at_y = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
    return bool(np.count_nonzero(crosses & (x < x_at_y)) % 2)


def _geom_contains(geom: dict, x: float, y: float) -> bool:
    """GeoJSON Polygon/MultiPolygon containment with holes (even-odd rule:
    point is inside iff inside the outer ring and outside every hole)."""
    polys = ([geom["coordinates"]] if geom["type"] == "Polygon"
             else geom["coordinates"])
    for rings in polys:
        arrs = [np.asarray(r, np.float64) for r in rings]
        if _ring_contains(arrs[0], x, y) and not any(
                _ring_contains(h, x, y) for h in arrs[1:]):
            return True
    return False


def _pip_join(df: pd.DataFrame, world_geojson: str) -> pd.DataFrame:
    """Built-in vector join: GeoJSON country layer → Country / Continent /
    ECONOMY columns via ray-casting point-in-polygon (no geopandas).
    Property names follow Natural Earth (``SOV_A3``/``CONTINENT``/
    ``ECONOMY``), falling back to already-renamed variants."""
    import json

    with open(world_geojson) as f:
        fc = json.load(f)
    feats = fc.get("features", [])
    country, continent, economy = [], [], []
    for x, y in zip(df.x, df.y):
        c, ct, ec = None, None, None
        for ft in feats:
            if _geom_contains(ft["geometry"], float(x), float(y)):
                pr = ft.get("properties", {})
                c = pr.get("SOV_A3", pr.get("Country"))
                ct = pr.get("CONTINENT", pr.get("Continent"))
                ec = pr.get("ECONOMY")
                break
        country.append(c if c is not None else "Unknown")
        continent.append(ct if ct is not None else "Unknown")
        economy.append(ec)
    df = df.copy()
    df["Country"], df["Continent"], df["ECONOMY"] = country, continent, economy
    return df


def _koppen_point_query_builtin(df, koppen_path):
    """Sample an EPSG:4326 Köppen raster at (lon, lat) via the built-in
    GeoTIFF reader (upper-left tiepoint + pixel-scale georeferencing)."""
    from nirgan_tpu_torch.data.geotiff import read_geotiff

    img, meta = read_geotiff(koppen_path)
    sx, sy = meta["pixel_scale"]
    _, _, _, ox, oy, _ = meta["tiepoint"]
    band = img[0]
    h, w = band.shape
    vals = []
    for x, y in zip(df.x, df.y):
        col = int(np.floor((float(x) - ox) / sx))
        row = int(np.floor((oy - float(y)) / sy))
        vals.append(int(band[row, col]) if 0 <= row < h and 0 <= col < w else None)
    return vals


def _koppen_classes(df, koppen_path, koppen_legend):
    if koppen_path and os.path.exists(koppen_path):
        try:
            try:
                from rasterstats import point_query
                from shapely.geometry import Point

                pts = [Point(x, y) for x, y in zip(df.x, df.y)]
                vals = point_query(pts, koppen_path)
            except ImportError:
                vals = _koppen_point_query_builtin(df, koppen_path)
            legend = pd.read_csv(koppen_legend) if koppen_legend else None
            out = []
            for v in vals:
                idx = int(v) if v is not None else 0
                if legend is not None and (legend["id"] == idx).any():
                    code = legend.loc[legend["id"] == idx, "Code"].values[0]
                    out.append(code[0].upper())
                else:
                    out.append("U")
            return out
        except Exception as e:
            print("Köppen join unavailable:", e)
    return ["U"] * len(df)


def points_to_geojson(df: pd.DataFrame, path: str):
    """Write a per-sample metric table as a GeoJSON point collection using
    plain json — no geopandas required (geopandas writes the same structure
    when present upstream)."""
    import json

    skip = {"x", "y", "geometry", "index_right"}
    features = []
    for _, row in df.iterrows():
        props = {}
        for k, v in row.items():
            if k in skip:
                continue
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            elif not isinstance(v, (str, int, float, bool, type(None))):
                continue
            props[k] = v
        features.append({
            "type": "Feature",
            "geometry": {"type": "Point",
                         "coordinates": [float(row["x"]), float(row["y"])]},
            "properties": props,
        })
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": features}, f)
