"""Dataset selection from config, counterpart of
``nirgan_tpu/data/select_dataset.py`` for one process.

``build_dataset``, the settings keys and the held-out split are the port's
own copies of the JAX package's; the DataModule differs, because the JAX
one asks its runtime for the process index.  This one is process 0 of 1.
The C++ ``native_loader`` fast path is not ported yet.
"""

from __future__ import annotations

import numpy as np

from nirgan_tpu_torch.data.datasets import (
    FakeDataset,
    GeoTiffFolderDataset,
    MixedDataset,
    NpzFolderDataset,
)
from nirgan_tpu_torch.data.pipeline import Loader

__all__ = ["DataModule", "dataset_selector", "build_dataset"]

_SETTINGS_KEY = {
    "SEN2NAIP": "sen2naip_settings",
    "S2NAIP": "sen2naip_settings",
    "S2_rand": "S2_rand_settings",
    "S2_75k": "S2_75k_settings",
    "S2_100k": "S2_100k_settings",
    "worldstrat": "worldstrat_settings",
    "L8_15k": "L8_15k_settings",
    "fake": "fake_settings",
}


def build_dataset(name: str, data_cfg, split: str = "train"):
    """One dataset by reference type name.  File-backed types auto-pick the
    reader by what's on disk (.npz/.npy first, GeoTIFF fallback)."""
    key = _SETTINGS_KEY.get(name)
    if key is None:
        raise NotImplementedError(f"dataset_type '{name}' is not recognised")
    st = data_cfg.get(key, {})
    image_size = int(st.get("image_size", 256))
    return_coords = bool(st.get("return_coords", False))

    if name == "fake":
        length = int(st.get("length", 64))
        if split == "val":
            length = max(8, length // 8)
        return FakeDataset(image_size=image_size, length=length,
                           return_coords=return_coords,
                           seed=0 if split == "train" else 1,
                           mode=st.get("mode", "rgb"))

    base = st.get("base_path", None)
    if base is None:
        raise ValueError(f"dataset '{name}' needs {key}.base_path")
    try:
        return NpzFolderDataset(base, image_size=image_size, return_coords=return_coords)
    except FileNotFoundError:
        return GeoTiffFolderDataset(base, image_size=image_size,
                                    return_coords=return_coords)


class _Subset:
    def __init__(self, ds, indices):
        self.ds, self.indices = ds, indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[int(self.indices[i])]


def _holdout_split(ds, every: int = 17):
    idx = np.arange(len(ds))
    val_idx = idx[::every]
    train_idx = np.setdiff1d(idx, val_idx)
    return _Subset(ds, train_idx), _Subset(ds, val_idx)


class DataModule:
    """Train and val loaders over the host pipeline for a single process."""

    def __init__(self, train_ds, val_ds, train_batch_size: int,
                 val_batch_size: int, num_workers: int = 0, seed: int = 0):
        self.train_ds, self.val_ds = train_ds, val_ds
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.num_workers = num_workers
        self.seed = seed

    def train_dataloader(self, transform=None) -> Loader:
        """``transform``: the loader applies it to each batch where the
        batch is made (``Loader``)."""
        return Loader(self.train_ds, self.train_batch_size, shuffle=True,
                      num_workers=self.num_workers, seed=self.seed,
                      drop_last=True, transform=transform)

    def val_dataloader(self, transform=None) -> Loader:
        return Loader(self.val_ds, self.val_batch_size, shuffle=False,
                      num_workers=self.num_workers, drop_last=True,
                      transform=transform)


def dataset_selector(config, seed: int = 0) -> DataModule:
    """config -> DataModule, as the JAX ``dataset_selector``: one dataset
    name or a list of them (a uniformly mixed dataset); the procedural
    ``fake`` type has its own val split, file-backed types hold out every
    17th item."""
    data_cfg = config.Data
    if data_cfg.get("native_loader", False):
        raise NotImplementedError("Data.native_loader: the C++ loader is "
                                  "not ported yet")
    kind = data_cfg.dataset_type
    names = list(kind) if isinstance(kind, (list, tuple)) else [kind]
    trains = [build_dataset(n, data_cfg, "train") for n in names]
    vals = [build_dataset(n, data_cfg, "val") for n in names]
    train_ds = trains[0] if len(trains) == 1 else MixedDataset(trains)
    val_ds = vals[0] if len(vals) == 1 else MixedDataset(vals)
    if not any(n == "fake" for n in names):
        train_ds, val_ds = _holdout_split(train_ds)
    return DataModule(train_ds, val_ds,
                      train_batch_size=int(data_cfg.train_batch_size),
                      val_batch_size=int(data_cfg.val_batch_size),
                      num_workers=int(data_cfg.get("num_workers", 0)),
                      seed=seed)
