"""S2-100K (image, location) dataset for SatCLIP pretraining: the port's
own copy of ``nirgan_tpu/data/s2geo.py`` (the contract of the reference's
vendored ``datamodules/s2geo_dataset.py`` + ``datamodules/transforms.py``):
items are ``{"image": (C,H,W) float, "point": (2,) lon/lat}``, with
train-time random crop / horizontal flip / gaussian blur and ±0.01°
coordinate jitter (``transforms.py:78-82``), on the port's own ``Loader``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from nirgan_tpu_torch.data.datasets import FakeDataset
from nirgan_tpu_torch.data.pipeline import Loader

__all__ = ["S2GeoDataset", "FakeS2GeoDataset", "PackedS2GeoDataset",
           "S2GeoDataModule", "pack_s2geo_shards", "train_transform"]


def _gaussian_blur_chw(img: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    return np.stack([gaussian_filter(c, sigma) for c in img])


def train_transform(item: dict, rng: np.random.Generator, crop: int = 256,
                    blur_p: float = 0.5, jitter: float = 0.01) -> dict:
    """Random crop + horizontal flip + gaussian blur + coordinate jitter."""
    img = item["image"]
    c, h, w = img.shape
    if h > crop and w > crop:
        y = rng.integers(0, h - crop)
        x = rng.integers(0, w - crop)
        img = img[:, y:y + crop, x:x + crop]
    if rng.random() < 0.5:
        img = img[:, :, ::-1].copy()
    if rng.random() < blur_p:
        img = _gaussian_blur_chw(img, sigma=float(rng.uniform(0.1, 2.0)))
    point = item["point"] + rng.uniform(-jitter, jitter, size=2).astype(np.float32)
    return {"image": img.astype(np.float32), "point": point.astype(np.float32)}


class S2GeoDataset:
    """Folder of .npz tiles with ``image`` (C,H,W, uint16 DN or float) and
    ``point``/``coords`` (2,)."""

    def __init__(self, base_path: str, crop: int = 256, augment: bool = True,
                 seed: int = 0, dn_scale: float = 10000.0):
        self.files = sorted(os.path.join(base_path, f)
                            for f in os.listdir(base_path) if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz tiles under {base_path!r}")
        self.crop, self.augment, self.seed, self.dn_scale = crop, augment, seed, dn_scale

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        z = np.load(self.files[idx])
        img = np.asarray(z["image"])
        if img.dtype.kind in "ui":
            img = img.astype(np.float32) / self.dn_scale
        point = np.asarray(z["point"] if "point" in z else z["coords"], np.float32)
        item = {"image": img.astype(np.float32), "point": point}
        if self.augment:
            rng = np.random.default_rng(self.seed * 7_919 + idx)
            item = train_transform(item, rng, crop=self.crop)
        else:
            item["image"] = item["image"][:, :self.crop, :self.crop]
        return item


def pack_s2geo_shards(dataset, out_dir: str, tiles_per_shard: int = 1024,
                      dtype=np.uint16, dn_scale: float = 10000.0) -> int:
    """Pack a tile dataset into mmap-able shards for 100k-scale pretraining.

    The reference's S2-100K corpus is a folder of ~100k individual files
    (``datamodules/s2geo_dataset.py``); at that scale per-item opens dominate
    host input time.  Each shard here is a pair
    ``shard-NNNNN.images.npy`` (N,C,H,W) + ``shard-NNNNN.points.npy`` (N,2):
    plain ``.npy`` so readers get zero-copy random access via
    ``np.load(mmap_mode='r')`` and the OS page cache turns epoch iteration
    into large sequential reads.  Integer dtypes store DN (value*dn_scale).
    Returns the number of shards written."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    n_shards = 0
    for s0 in range(0, n, tiles_per_shard):
        idxs = range(s0, min(s0 + tiles_per_shard, n))
        imgs, pts = [], []
        for i in idxs:
            item = dataset[i]
            img = np.asarray(item["image"], np.float32)
            if np.issubdtype(np.dtype(dtype), np.integer):
                # rint, not truncation: float32 DN/10000*10000 can land at
                # DN-eps and astype() floors, shifting the stored DN by 1
                img = np.clip(np.rint(img * dn_scale), 0,
                              np.iinfo(dtype).max).astype(dtype)
            else:
                img = img.astype(dtype)
            imgs.append(img)
            pts.append(np.asarray(item["point"], np.float32))
        tag = os.path.join(out_dir, f"shard-{n_shards:05d}")
        np.save(tag + ".images.npy", np.stack(imgs))
        np.save(tag + ".points.npy", np.stack(pts))
        n_shards += 1
    return n_shards


class PackedS2GeoDataset:
    """Map-style view over :func:`pack_s2geo_shards` output.

    Shards are opened lazily with ``np.load(mmap_mode='r')`` — no data is
    read until a tile is touched, so 50 GB-scale corpora cost no RSS and the
    ``Loader``'s shuffled multi-host slicing (``process_index/count``) works
    unchanged on top.  Augmentation matches :class:`S2GeoDataset`."""

    def __init__(self, base_path: str, crop: int = 256, augment: bool = True,
                 seed: int = 0, dn_scale: float = 10000.0):
        tags = sorted(os.path.join(base_path, f[:-len(".images.npy")])
                      for f in os.listdir(base_path)
                      if f.endswith(".images.npy"))
        if not tags:
            raise FileNotFoundError(f"no packed shards under {base_path!r}")
        self.crop, self.augment, self.seed, self.dn_scale = (
            crop, augment, seed, dn_scale)
        self._tags = tags
        self._mmaps: dict = {}
        # cumulative item offsets — mmap open reads only the .npy header
        counts = [np.load(t + ".points.npy", mmap_mode="r").shape[0]
                  for t in tags]
        self._starts = np.concatenate([[0], np.cumsum(counts)])

    def __len__(self):
        return int(self._starts[-1])

    def _shard(self, s: int):
        if s not in self._mmaps:
            tag = self._tags[s]
            self._mmaps[s] = (np.load(tag + ".images.npy", mmap_mode="r"),
                              np.load(tag + ".points.npy", mmap_mode="r"))
        return self._mmaps[s]

    def __getitem__(self, idx):
        s = int(np.searchsorted(self._starts, idx, side="right") - 1)
        images, points = self._shard(s)
        img = np.asarray(images[idx - self._starts[s]])
        if img.dtype.kind in "ui":
            img = img.astype(np.float32) / self.dn_scale
        item = {"image": img.astype(np.float32),
                "point": np.asarray(points[idx - self._starts[s]], np.float32)}
        if self.augment:
            rng = np.random.default_rng(self.seed * 7_919 + idx)
            return train_transform(item, rng, crop=self.crop)
        item["image"] = item["image"][:, :self.crop, :self.crop]
        return item


class FakeS2GeoDataset:
    """Procedural stand-in for tests / smoke training.

    ``mode="geo"``: the 4th (NIR) channel is the same coordinate-dependent
    soil/veg blend as ``FakeDataset(mode="geo")`` (``datasets.py``), so the
    image content genuinely correlates with location and the contrastive
    objective has real geographic structure to align — a meaningful native
    pretraining signal for the pretrain→inject workflow."""

    def __init__(self, length: int = 32, crop: int = 64, channels: int = 4,
                 augment: bool = True, seed: int = 0, mode: str = "rand"):
        self.length, self.crop, self.channels = length, crop, channels
        self.augment, self.seed = augment, seed
        if mode not in ("rand", "geo"):
            raise ValueError(f"FakeS2GeoDataset mode {mode!r} not in ('rand','geo')")
        self.mode = mode

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 104_729 + idx)
        s = self.crop + 16
        img = rng.random((self.channels, s, s), dtype=np.float32)
        point = np.asarray([rng.uniform(-180, 180), rng.uniform(-90, 90)],
                           np.float32)
        if self.mode == "geo" and self.channels >= 4:
            rgb = img[:3]
            veg = FakeDataset.veg_response(rgb)
            soil = FakeDataset.soil_response(rgb)
            g = FakeDataset.geo_mix(float(point[0]), float(point[1]))
            img[3] = ((1.0 - g) * soil + g * veg)[0]
        item = {"image": img, "point": point}
        return (train_transform(item, rng, crop=self.crop, blur_p=0.3)
                if self.augment else
                {"image": img[:, :self.crop, :self.crop], "point": point})


class S2GeoDataModule:
    """train/val loader pair (reference ``S2GeoDataModule`` contract)."""

    def __init__(self, dataset=None, base_path: Optional[str] = None,
                 batch_size: int = 32, crop: int = 256, num_workers: int = 4):
        if dataset is None:
            packed = any(f.endswith(".images.npy")
                         for f in os.listdir(base_path))
            dataset = (PackedS2GeoDataset(base_path, crop=crop) if packed
                       else S2GeoDataset(base_path, crop=crop))
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def train_dataloader(self):
        return Loader(self.dataset, self.batch_size, shuffle=True,
                      num_workers=self.num_workers, drop_last=True)

    def val_dataloader(self):
        return Loader(self.dataset, self.batch_size, shuffle=False,
                      num_workers=self.num_workers, drop_last=True)
