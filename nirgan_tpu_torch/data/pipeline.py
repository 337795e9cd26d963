"""Host-side input pipeline: the port's own copy of ``collate`` and
``Loader`` from ``nirgan_tpu/data/pipeline.py``.

The reference's only async machinery is torch DataLoader workers with
prefetch (``configs/config_px2px.yaml:82-84``; SURVEY.md §2.9 row 5).
``Loader`` is a thread-pool item fetch + collate into numpy batch dicts,
with a bounded prefetch queue (threads suffice: item decode is numpy C code
that releases the GIL).  The JAX package's ``DeviceFeed`` (a batch in flight
on the device) has no counterpart here yet.  One addition over the original:
``transform``, a function applied to each collated batch where it is made
(the producer thread when there are workers), so host work that belongs to
a batch, like the SatCLIP tower, stays off the consumer's thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["Loader", "collate"]


def collate(items) -> dict:
    """List of item dicts → batch dict of stacked arrays (string fields
    become lists, like torch's default collate for str)."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class Loader:
    """Minimal map-style batch loader: shuffle, batch, drop_last, threaded
    prefetch.  Iterating yields numpy batch dicts; one pass = one epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1,
                 transform: Optional[Callable[[dict], dict]] = None):
        """``transform``: applied to every collated batch before it is
        yielded.  ``process_index``/``process_count``: multi-host input sharding
        (SURVEY.md §2.9 host-side input parallelism) — every host permutes
        the SAME epoch order (seeded identically) and takes its strided
        slice, so the union of all hosts' batches is a disjoint cover of the
        epoch and per-host batches stay ``batch_size`` (the per-host batch
        of the global ``data``-sharded step).  The port runs one process, so
        it leaves them at 0 of 1."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = max(0, int(num_workers))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        self.transform = transform or (lambda batch: batch)
        self._epoch = 0

    def __len__(self):
        if self.drop_last:
            # SPMD lockstep: every host must run the SAME number of batches
            # (train/val loops launch collective programs per batch), so the
            # count derives from the host-invariant floor(N/P) — the ragged
            # tail is dropped on every host, DistributedSampler-style.
            n = len(self.dataset) // self.process_count
            return n // self.batch_size
        # drop_last=False is the collective-free path (bulk serving): this
        # process's strided slice can hold ceil(N/P) items and every one
        # must be yielded by exactly one host (floor dropped tail tiles).
        n = len(range(self.process_index, len(self.dataset),
                      self.process_count))
        return -(-n // self.batch_size)

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.process_count > 1:
            idx = idx[self.process_index::self.process_count]
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        if self.num_workers == 0:
            for batch_idx in self._batches():
                yield self.transform(
                    collate([self.dataset[int(i)] for i in batch_idx]))
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              [int(i) for i in batch_idx]))
                        q.put(self.transform(collate(items)))
                finally:
                    q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            while not q.empty():
                q.get_nowait()
