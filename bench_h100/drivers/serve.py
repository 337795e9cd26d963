"""The bulk serving cell: ``synthesize_dataset``'s loop without its
``.npz`` writers.  The program's ``Loader`` (``num_workers`` threads, no
shuffle, the task's ``embed_coords`` as its transform) yields batches of
uint16 tiles; each goes ``_ingest`` -> ``serve_batch`` (DN scaling, the
shape bucket, G, the histogram match, fp16) -> ``stager.to_host``, and batch
v is queued before batch v - 1's result is waited for.  A tile counts once
its result is on the host.

Set-up binds the seeded weights and serves ``warmup_batches`` (with
``serving_quant: int8`` the first calibrates the trunk).  During the window
a sample of ``sample`` tiles, drawn from the seed over all the tiles the
window completed (a reservoir), is kept on the host; after it the program
is freed and the reference serves those tiles from the same weights and
inputs.  ``rel_rmse`` compares them: the largest, over the sampled tiles,
root mean square of the program's output minus the reference's over the
spread of the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import core, traffic as traffic_mod, trace as trace_mod, weights
from bench_h100.drivers import (
    memory_peak,
    program_config,
    reference_precision,
    release,
    seeded_weights,
    shapes,
)
from bench_h100.reference import int8 as ref_int8, pix2pix, serve as ref_serve
from bench_h100.timing import Spans, synchronize


class Reservoir:
    """A uniform sample of ``k`` of the offered items (Algorithm R), the
    draws from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.rng = np.random.default_rng(seed)
        self.items: list = []

    def offer(self, key, value) -> None:
        if len(self.items) < self.k:
            self.items.append((key, np.array(value)))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (key, np.array(value))
        self.seen += 1


class Session:
    """The program's serving loop for one seed: the task with the seeded
    weights bound, the loader over the seeded tiles, the batch in flight and
    the sample of completed tiles."""

    def __init__(self, cell, seed: int, device):
        from nirgan_tpu_torch.data.pipeline import Loader
        from nirgan_tpu_torch.tasks.px2px import Px2PxTask

        self.device = torch.device(device)
        s = cell.settings
        self.batch = int(s["batch"])
        self.task = Px2PxTask(program_config(cell), device=self.device, seed=seed)
        self.task.bind(seeded_weights(cell, seed, self.device)[0])
        self.data = traffic_mod.SRTiles(cell.traffic, weights.subseed(seed, 3), self.device)
        loader = Loader(self.data, self.batch, shuffle=False,
                        num_workers=int(s["num_workers"]), drop_last=False,
                        transform=self.task.embed_coords)
        self.batches = iter(loader)
        self.sample = Reservoir(int(s["sample"]), weights.subseed(seed, 4))
        self.pending = None
        self.done = 0

    def flush(self, spans: Spans, keep: bool) -> None:
        """Wait for the batch in flight; count its tiles, offer them to
        the sample where ``keep``."""
        if self.pending is None:
            return
        fetched, tiles = self.pending
        with spans("to_host"):
            out = fetched.result()
            if keep:
                for t, y in zip(tiles, out):
                    self.sample.offer(int(t), y[..., 0])
        self.done += len(tiles)
        self.pending = None

    def one(self, spans: Spans, keep: bool) -> None:
        """Queue the next batch, then wait for the one before it."""
        from nirgan_tpu_torch.inference.synthesize import serve_batch

        with spans("load_batch"):
            b = next(self.batches)
            hr, s2 = self.task._ingest(b["hr"], b["s2_nir"])
        with spans("serve_batch"):
            y = serve_batch(self.task, hr, s2, True, embeds=b.get("embeds"))
            fetched = self.task.stager.to_host(y)
        self.flush(spans, keep)
        self.pending = (fetched, b["tile"])

    def close(self) -> None:
        self.batches.close()
        self.batches = self.task = None
        release(self.device)


def judge(cell, seed: int, session: Session, device) -> dict:
    """``rel_rmse`` of the sampled tiles against the reference's."""
    ids = np.array([t for t, _ in session.sample.items])
    got = np.stack([y for _, y in session.sample.items])[:, None]
    want = reference(cell, seed, session.data, ids, device)
    return {"rel_rmse": ref_serve.worst_rel_rmse(got, want)}


def reference(cell, seed: int, data, ids, device, arith=pix2pix.PLAIN,
              bits: int = 8) -> np.ndarray:
    """The reference's output for the tiles ``ids``; with ``serving_quant:
    int8`` its integer trunk of ``bits``, calibrated as the program is on
    the first rows it served (the loader's first batch: tiles 0, 1, ...)."""
    wg = seeded_weights(cell, seed, device)[0]
    with reference_precision():
        trunk = None
        if cell.config.get("tpu", {}).get("serving_quant", "none") == "int8":
            dn = float(cell.config["Data"].get("dn_scale", 10000.0))
            x = torch.from_numpy(data.hr[:ref_int8.CALIB_ROWS].astype(np.float32))
            trunk = ref_int8.trunk(ref_int8.calibrate(wg, x.to(device) / dn, cell.config,
                                                      bits))
        return ref_serve.serve(wg, data.hr[ids], data.lr[ids, 3:4], cell.config, arith,
                               device, int(cell.settings.get("reference_chunk", 4)),
                               trunk=trunk)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> core.Run:
    device = torch.device(device)
    s = cell.settings
    marks = [("imports", time.perf_counter() - t_start)]
    sess = Session(cell, seed, device)
    marks.append(("session", time.perf_counter() - t_start))
    idle = Spans(on=False)
    for _ in range(int(s["warmup_batches"])):
        sess.one(idle, False)
    sess.flush(idle, False)
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))

    spans = Spans()
    sess.done, n = 0, 0
    t0 = time.perf_counter()
    while True:
        sess.one(spans, True)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sess.flush(spans, True)
    synchronize(device)
    window_s = time.perf_counter() - t0
    tiles = sess.done

    dtrace = None
    if trace:
        k = int(s["trace_batches"])
        annotated = Spans(annotate=True)

        def traced() -> int:
            for _ in range(k):
                sess.one(annotated, False)
            sess.flush(annotated, False)
            return k

        dtrace = trace_mod.profile(traced, device)
    peak = memory_peak(device)
    sess.close()

    got = judge(cell, seed, sess, device)
    checks = {k: (got[k], limit) for k, limit in cell.limits.items()}
    batch = sess.batch
    return core.Run(
        end_to_end={"serve_tiles_per_s": tiles / window_s, "setup_s": setup_s},
        window_s=window_s, units=n, work=tiles, attempted=n * batch,
        failed=n * batch - tiles, memory_peak_bytes=peak, checks=checks,
        spans=spans.totals, trace=dtrace, marks=marks,
        shapes=shapes(cell, batch, int(cell.traffic["tile"])))
