"""Dataset layer: the port's own copy of ``nirgan_tpu/data/datasets.py``.

The reference's entire ``data/`` package is gitignored upstream (SURVEY.md
§0.1); these classes are re-specified from the observable contract: every
item is ``{"rgb": (3,H,W) float32, "nir": (1,H,W) float32
[, "coords": (2,) lon/lat degrees]}`` with reflectance = uint16 DN / 10000
(``README.md:108-110``, ``data/SR_dataset_RGB.py:30``).

Map-style datasets (``__len__`` / ``__getitem__``) feed the threaded host
loader in ``pipeline.py``.  File-backed datasets read 4-band rasters
(R,G,B,NIR): ``.npy``/``.npz`` natively, GeoTIFF via rasterio or tifffile
when available (gated — neither ships in this image).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "FakeDataset",
    "ArrayDataset",
    "NpzFolderDataset",
    "GeoTiffFolderDataset",
    "MixedDataset",
    "SRPairedDataset",
    "center_crop_chw",
]


def center_crop_chw(img: np.ndarray, size: int) -> np.ndarray:
    c, h, w = img.shape
    if h == size and w == size:
        return img
    y = max((h - size) // 2, 0)
    x = max((w - size) // 2, 0)
    return img[:, y:y + size, x:x + size]


class FakeDataset:
    """Procedural in-memory dataset implementing the batch-dict contract —
    the train-without-rasters path the survey's test plan calls for
    (SURVEY.md §4c).

    ``mode="rgb"`` (default): NIR is a deterministic clipped-linear function
    of RGB — plumbing-level signal any regressor can fit.

    ``mode="geo"``: NIR is a **coordinate-dependent** blend of two distinct
    RGB responses, ``nir = (1-g)·soil + g·veg`` with the mixing factor
    ``g(lon, lat)`` a smooth low-degree function on the sphere and
    veg/soil different linear maps of RGB.  From RGB alone ``g`` is
    unidentifiable, so an RGB-only model carries an irreducible error
    proportional to ``E|g-ĝ|·|veg-soil|``; a location-conditioned model
    (the SatCLIP inject/concat routes) can recover it.  This is the
    synthetic analogue of the reference's geographic-prior premise
    (``reference README.md:17-31``) and feeds the SatCLIP-vs-plain
    A/B the validation suite draws (``plot_val_spiders.py:13-87``)."""

    def __init__(self, image_size: int = 256, length: int = 64,
                 return_coords: bool = False, seed: int = 0,
                 mode: str = "rgb"):
        self.image_size = int(image_size)
        self.length = int(length)
        self.mode = str(mode)
        if self.mode not in ("rgb", "geo"):
            raise ValueError(f"FakeDataset mode {mode!r} not in ('rgb','geo')")
        # geo mode is pointless without coordinates
        self.return_coords = bool(return_coords) or self.mode == "geo"
        self.seed = seed

    def __len__(self):
        return self.length

    @staticmethod
    def geo_mix(lon: float, lat: float) -> float:
        """The mixing factor g(lon, lat) ∈ [0.05, 0.95]: degree-≤2 spherical
        signal — well inside what an l=10 SH + SIREN location encoder (or a
        linear readout of a random frozen one) can represent."""
        latr, lonr = np.radians(lat), np.radians(lon)
        return float(0.5 + 0.25 * np.sin(2.0 * latr)
                     + 0.2 * np.cos(latr) * np.sin(lonr))

    @staticmethod
    def veg_response(rgb):
        """Vegetation-like NIR response: high where green dominates red.
        Shared with FakeS2GeoDataset so both fakes stay one generative
        family; ``rgb``: (3, H, W) or channel-sliced rows."""
        return np.clip(0.55 * rgb[1:2] - 0.25 * rgb[0:1]
                       + 0.35 * rgb[2:3] + 0.15, 0, 1)

    @staticmethod
    def soil_response(rgb):
        return np.clip(0.6 * rgb[0:1] - 0.2 * rgb[1:2]
                       + 0.3 * rgb[2:3] + 0.25, 0, 1)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        s = self.image_size
        # smooth random fields: low-res noise upsampled by FFT-free kron
        base = rng.random((3, s // 8, s // 8)).astype(np.float32)
        rgb = np.kron(base, np.ones((1, 8, 8), np.float32))
        rgb += 0.05 * rng.random((3, s, s)).astype(np.float32)
        rgb = np.clip(rgb / rgb.max(), 0.0, 1.0)
        coords = np.asarray(
            [rng.uniform(-180, 180), rng.uniform(-60, 70)], np.float32)
        veg = self.veg_response(rgb)
        if self.mode == "geo":
            soil = self.soil_response(rgb)
            g = self.geo_mix(float(coords[0]), float(coords[1]))
            nir = np.clip((1.0 - g) * soil + g * veg, 0, 1)
        else:
            nir = veg
        item = {"rgb": rgb, "nir": nir.astype(np.float32)}
        if self.return_coords:
            item["coords"] = coords
        return item


class ArrayDataset:
    """Wrap pre-loaded arrays: rgb (N,3,H,W), nir (N,1,H,W), coords (N,2)?"""

    def __init__(self, rgb, nir, coords=None):
        self.rgb = np.asarray(rgb, np.float32)
        self.nir = np.asarray(nir, np.float32)
        self.coords = None if coords is None else np.asarray(coords, np.float32)

    def __len__(self):
        return len(self.rgb)

    def __getitem__(self, idx):
        item = {"rgb": self.rgb[idx], "nir": self.nir[idx]}
        if self.coords is not None:
            item["coords"] = self.coords[idx]
        return item


class NpzFolderDataset:
    """Folder of ``.npz``/``.npy`` tiles.

    ``.npz`` keys: ``rgb`` (3,H,W) + ``nir`` (1|H,W) [+ ``coords`` (2,)], or a
    single 4-band ``image`` / bare ``.npy`` array (4,H,W) RGBN.  Values may be
    uint16 DN (scaled by /10000, the S2 convention) or float reflectance.
    """

    def __init__(self, base_path: str, image_size: int = 256,
                 return_coords: bool = False, dn_scale: float = 10000.0):
        self.base_path = base_path
        self.image_size = int(image_size)
        self.return_coords = bool(return_coords)
        self.dn_scale = dn_scale
        self.files: List[str] = sorted(
            os.path.join(base_path, f) for f in os.listdir(base_path)
            if f.endswith((".npz", ".npy")))
        if not self.files:
            raise FileNotFoundError(f"no .npz/.npy tiles under {base_path!r}")

    def __len__(self):
        return len(self.files)

    @staticmethod
    def _to_reflectance(a: np.ndarray, dn_scale: float) -> np.ndarray:
        a = np.asarray(a)
        if a.dtype.kind in "ui":
            return a.astype(np.float32) / dn_scale
        return a.astype(np.float32)

    def __getitem__(self, idx):
        path = self.files[idx]
        coords = None
        if path.endswith(".npy"):
            img = self._to_reflectance(np.load(path), self.dn_scale)
            rgb, nir = img[:3], img[3:4]
        else:
            z = np.load(path)
            if "rgb" in z:
                rgb = self._to_reflectance(z["rgb"], self.dn_scale)
                nir = self._to_reflectance(z["nir"], self.dn_scale)
                if nir.ndim == 2:
                    nir = nir[None]
            else:
                img = self._to_reflectance(z[list(z.files)[0]], self.dn_scale)
                rgb, nir = img[:3], img[3:4]
            if "coords" in z:
                coords = np.asarray(z["coords"], np.float32)
        item = {"rgb": center_crop_chw(rgb, self.image_size),
                "nir": center_crop_chw(nir, self.image_size)}
        if self.return_coords:
            item["coords"] = coords if coords is not None else np.zeros(2, np.float32)
        return item


class GeoTiffFolderDataset:
    """Folder of 4-band GeoTIFFs (R,G,B,NIR uint16 DN).  Serves the
    S2_75k / S2_100k / L8_15k / SEN2NAIP / worldstrat settings blocks
    (config keys at ``configs/config_px2px_SatCLIP.yaml:117-150``).

    Reading uses rasterio when installed (arbitrary CRS/compression via
    GDAL); otherwise the built-in no-deps reader
    (``nirgan_tpu_torch/data/geotiff.py``: baseline striped/tiled TIFF, UTM or
    WGS84 coords) — so the GeoTIFF contract of the reference
    (``data/SR_dataset_RGB.py:29-43``: 4-band read, DN/10000,
    centroid→EPSG:4326) works everywhere."""

    def __init__(self, base_path: str, image_size: int = 256,
                 return_coords: bool = False, dn_scale: float = 10000.0):
        self.base_path = base_path
        self.image_size = int(image_size)
        self.return_coords = bool(return_coords)
        self.dn_scale = dn_scale
        self.files = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(base_path) for f in fs
            if f.lower().endswith((".tif", ".tiff")))
        if not self.files:
            raise FileNotFoundError(f"no GeoTIFFs under {base_path!r}")
        try:
            import rasterio  # noqa: F401

            self._backend = "rasterio"
        except ImportError:
            self._backend = "builtin"

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        path = self.files[idx]
        coords = np.zeros(2, np.float32)
        if self._backend == "rasterio":
            import rasterio
            from rasterio.warp import transform as rio_transform

            with rasterio.open(path) as src:
                img = src.read().astype(np.float32) / self.dn_scale
                cx, cy = src.xy(src.height // 2, src.width // 2)
                try:
                    lon, lat = rio_transform(src.crs, "EPSG:4326", [cx], [cy])
                    coords = np.asarray([lon[0], lat[0]], np.float32)
                except Exception:
                    pass
        else:
            from nirgan_tpu_torch.data.geotiff import centroid_lonlat, read_geotiff

            img, meta = read_geotiff(path, dn_scale=self.dn_scale)
            ll = centroid_lonlat(meta)
            if ll is not None:
                coords = ll
        item = {"rgb": center_crop_chw(img[:3], self.image_size),
                "nir": center_crop_chw(img[3:4], self.image_size)}
        if self.return_coords:
            item["coords"] = coords
        return item


class MixedDataset:
    """Uniform concatenation of several datasets — the reference's mixed
    ``dataset_type`` list ("randomly sampled during training",
    ``README.md:54``; exact sampling was unspecified upstream, SURVEY.md
    §7.3.4 — we document uniform-over-items)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


class SRPairedDataset:
    """LR/HR paired tiles for the bulk-synthesis pipeline (contract of the
    reference ``data/SR_dataset_RGB.py:8-56``): items are
    {"lr": (3,h,w), "hr": (3,H,W), "s2_nir": (1,h,w), "coords": (2,),
    "id": str}.  Reads ``LR/`` + ``HR/`` subfolders of 4-band (LR) and
    3+-band (HR) rasters, .npz or GeoTIFF."""

    def __init__(self, root_dir: str, dn_scale: float = 10000.0,
                 dn_passthrough: bool = False):
        """``dn_passthrough``: keep integer DN rasters in their native dtype
        (uint16 = 2 B/px instead of f32's 4) — the serving pipeline scales
        DN/dn_scale on device (``synthesize_dataset``), halving ingest
        bytes.  Default off to keep the reference item contract
        (``data/SR_dataset_RGB.py:30``: float reflectance)."""
        self.lr_dir = os.path.join(root_dir, "LR")
        self.hr_dir = os.path.join(root_dir, "HR")
        exts = (".npz", ".npy", ".tif", ".tiff")
        self.names = sorted(
            f for f in os.listdir(self.lr_dir)
            if f.lower().endswith(exts) and os.path.isfile(os.path.join(self.hr_dir, f)))
        self.dn_scale = dn_scale
        self.dn_passthrough = dn_passthrough

    def __len__(self):
        return len(self.names)

    def _read(self, path):
        if path.endswith((".npz", ".npy")):
            z = np.load(path)
            img = z[list(z.files)[0]] if hasattr(z, "files") else z
            coords = np.asarray(z["coords"], np.float32) if hasattr(z, "files") and "coords" in z else None
            img = np.asarray(img)
        else:
            from nirgan_tpu_torch.data.geotiff import centroid_lonlat, read_geotiff

            # dn_scale: integer DN rasters come back scaled to reflectance
            # (read_geotiff returns float32, so the integer check below
            # cannot catch them) — unless passthrough keeps the native dtype
            img, meta = read_geotiff(path, dn_scale=self.dn_scale,
                                     native_dtype=self.dn_passthrough)
            coords = centroid_lonlat(meta)  # reference SR_dataset_RGB.py:31-37
        if img.dtype.kind in "ui":
            # passthrough only for the dtypes the serving ingest keeps
            # integer (synthesize.ingest: uint8/uint16) — wider ints would
            # reach the device as *floats* and skip the on-device DN scale
            if self.dn_passthrough and img.dtype in (np.uint8, np.uint16):
                return img, coords
            img = img.astype(np.float32) / self.dn_scale
        return img.astype(np.float32), coords

    def __getitem__(self, idx):
        name = self.names[idx]
        lr, coords = self._read(os.path.join(self.lr_dir, name))
        hr, _ = self._read(os.path.join(self.hr_dir, name))
        return {
            "lr": lr[:3],
            "hr": hr[:3],
            "s2_nir": lr[3:4],
            "coords": coords if coords is not None else np.zeros(2, np.float32),
            "id": os.path.splitext(name)[0],
        }
