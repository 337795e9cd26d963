"""Shipped coarse geo layers for the validation ablation joins: the port's
own copies of ``nirgan_tpu/validation/layers`` (its three data files, byte
for byte, and this module).

The reference hard-codes absolute paths to a Natural-Earth countries
shapefile and the Beck Köppen raster on the author's machine
(``validation_utils/geo_ablation.py:18,33-34``) — neither is distributable
here.  So the package ships a small curated substitute that keeps the
Country/Continent/economy/Köppen grouping *functional* out of the box:

* ``continents_coarse.geojson`` — six hand-drawn macro-region polygons
  (~1000-km fidelity) with Natural-Earth-compatible properties
  (``SOV_A3``/``CONTINENT``/``ECONOMY``),
* ``koppen_coarse.tif`` + ``koppen_legend.csv`` — a 1°/px global raster of
  latitude-band climate classes (A/B/C/D/E), DEFLATE-compressed by our own
  GeoTIFF writer.

Production deployments point the env vars at real layers; the join code
(`geo_ablation.py`) is format-compatible with the reference's inputs.
"""

from __future__ import annotations

import os

__all__ = ["default_world_path", "default_koppen_paths"]

_DIR = os.path.dirname(os.path.abspath(__file__))


def default_world_path() -> str | None:
    """Country/continent/economy vector layer: ``NIRGAN_WORLD_LAYER`` env
    override (a .geojson, or any geopandas-readable file when geopandas is
    installed), else the shipped coarse layer."""
    p = os.environ.get("NIRGAN_WORLD_LAYER")
    if p:
        return p if os.path.exists(p) else None
    return os.path.join(_DIR, "continents_coarse.geojson")


def default_koppen_paths() -> tuple[str | None, str | None]:
    """(raster, legend csv) for the Köppen class query; env overrides
    ``NIRGAN_KOPPEN_LAYER`` / ``NIRGAN_KOPPEN_LEGEND``."""
    p = os.environ.get("NIRGAN_KOPPEN_LAYER")
    leg = os.environ.get("NIRGAN_KOPPEN_LEGEND")
    if p:
        return (p if os.path.exists(p) else None), leg
    return (os.path.join(_DIR, "koppen_coarse.tif"),
            os.path.join(_DIR, "koppen_legend.csv"))
