"""Dataset selection from config, counterpart of
``nirgan_tpu/data/select_dataset.py`` for one process.

The datasets, their construction from config and the host loader are the
JAX package's own (``build_dataset``, ``MixedDataset``, the held-out split
and ``Loader`` are numpy only); only the DataModule differs, because the
JAX one asks jax for the process index.  This one is process 0 of 1.  The
C++ ``native_loader`` fast path is not ported yet.
"""

from __future__ import annotations

from nirgan_tpu.data.datasets import MixedDataset
from nirgan_tpu.data.pipeline import Loader
from nirgan_tpu.data.select_dataset import _holdout_split, build_dataset

__all__ = ["DataModule", "dataset_selector"]


class DataModule:
    """Train and val loaders over the host pipeline for a single process."""

    def __init__(self, train_ds, val_ds, train_batch_size: int,
                 val_batch_size: int, num_workers: int = 0, seed: int = 0):
        self.train_ds, self.val_ds = train_ds, val_ds
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.num_workers = num_workers
        self.seed = seed

    def train_dataloader(self) -> Loader:
        return Loader(self.train_ds, self.train_batch_size, shuffle=True,
                      num_workers=self.num_workers, seed=self.seed,
                      drop_last=True)

    def val_dataloader(self) -> Loader:
        return Loader(self.val_ds, self.val_batch_size, shuffle=False,
                      num_workers=self.num_workers, drop_last=True)


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
