"""The training cell: ``Px2PxTask.train_step`` fed as ``Trainer.fit`` feeds
it (the program's ``DataModule`` loader, then ``DeviceFeed`` at
``tpu.prefetch_depth``, the loss pulled to the host every ``log_every``
steps and checked finite), validation and checkpoints left out.  The
loader runs ``num_workers`` threads (the cell's setting, else the
config's).  A pulled loss is read at the next pull, ``log_every`` steps
later, so a pull waits for none of the work queued after it.

Set-up builds the task and its train state once, binds the seeded weights,
and drives that same state through the window's own feed and call: steps
1-3 are the ones the reference follows, the rest warm up every shape the
window meets (``warmup_steps`` reaches a step that computes the train
metrics).  After the window (and the traced steps) the program is freed and
the reference repeats steps 1-3 on the same rows from the same weights.
What is compared, each against its limit in ``workloads/<cell>.json``
(``readings`` also gives ``loss_gap``, the same over all three steps, which
no limit holds: after D's first updates bf16 and float32 take D apart, so
the third step's D loss swings from seed to seed):

- ``first_loss_gap``: the larger relative gap of D's and G's loss in step 1;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), the largest gap between the
  program's and the reference's norm of a leaf, over the larger of the
  reference's norm of that leaf and of its network's median leaf;
- ``change_gap``: the median leaf's gap of the parameters' change over the
  three steps (each leaf's gap measured as the gradient's), over the leaves
  whose reference gradient is at least a thousandth of their network's
  median leaf's (the conv biases before an instance norm get a round-off
  gradient that Adam turns into +-lr steps);
- ``leaf_change_gap``: over the same leaves, the largest gap of a leaf's
  change over the reference's norm of that leaf's change alone, so that a
  leaf left unmoved or moved twice reads 1 however small it is.
"""

from __future__ import annotations

import statistics
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
from bench_h100.reference import pix2pix
from bench_h100.timing import Spans, StepClock, p95, synchronize

WATCHED = ("model_loss/discriminator_loss", "model_loss/generator_total_loss")


def _pull(metrics: dict) -> np.ndarray:
    """The watched losses in one copy to the host."""
    return torch.stack([metrics[k].float() for k in WATCHED]).cpu().numpy()


def _pull_late(metrics: dict) -> tuple:
    """The watched losses' copy to the host, started behind the work queued
    so far and not waited for: (host tensor, event that marks it done)."""
    v = torch.stack([metrics[k].float() for k in WATCHED])
    if not v.is_cuda:
        return v.clone(), None
    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
    host.copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def leaf_norms(named: dict) -> dict:
    keys = list(named)
    vals = torch.stack([named[k].detach().float().norm() for k in keys]).cpu().numpy()
    return dict(zip(keys, vals.astype(float)))


def program_grads(task, state, beta1: float) -> dict:
    """Each leaf's first gradient, from its Adam first moment after step 1."""
    out = {}
    for tag, net, opt in (("G", task.netG, state.opt_g), ("D", task.netD, state.opt_d)):
        for name, p in net.named_parameters():
            out[f"{tag}.{name}"] = opt.state[p]["exp_avg"] / (1.0 - beta1)
    return leaf_norms(out)


def changes(task, w0: tuple) -> dict:
    out = {}
    for tag, net, w in (("G", task.netG, w0[0]), ("D", task.netD, w0[1])):
        for name, p in net.named_parameters():
            out[f"{tag}.{name}"] = p.detach() - w[name]
    return leaf_norms(out)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of its first gradient's norm and of its change's
    (``grad`` and ``change``: {leaf: (gap, program's, reference's)}), the
    change over the leaves whose reference gradient is at least a
    thousandth of their network's median leaf's."""
    out = {"grad": {}, "change": {}}
    for tag in ("G", "D"):
        leaves = [k for k in ref["grad"] if k.startswith(tag + ".")]
        gmed = statistics.median(ref["grad"][k] for k in leaves)
        kept = [k for k in leaves if ref["grad"][k] >= 1e-3 * gmed]
        cmed = statistics.median(ref["change"][k] for k in kept)
        for what, keys, med in (("grad", leaves, gmed), ("change", kept, cmed)):
            for k in keys:
                p, r = prog[what][k], ref[what][k]
                out[what][k] = (abs(p - r) / max(r, med), p, r)
    return out


def readings(prog: dict, ref: dict) -> dict:
    """The three compared numbers of ``prog`` against ``ref``, each
    {"losses": [(d, g)] * 3, "grad": {leaf: norm}, "change": {leaf: norm}}."""
    def gap(steps):
        return max(abs(p - r) / abs(r) for ps, rs in steps for p, r in zip(ps, rs))

    steps = list(zip(prog["losses"], ref["losses"]))
    gaps = leaf_gaps(prog, ref)
    change = [g for g, _, _ in gaps["change"].values()]
    own = [abs(p - r) / r for _, p, r in gaps["change"].values()]
    return {"first_loss_gap": gap(steps[:1]), "loss_gap": gap(steps),
            "grad_gap": max(g for g, _, _ in gaps["grad"].values()),
            "change_gap": statistics.median(change), "leaf_change_gap": max(own)}


def reference(cell, seed: int, rows: tuple, device, arith=pix2pix.PLAIN) -> dict:
    """The reference's three steps from the seeded weights on ``rows``,
    ((rgb, nir) f32 numpy a step)."""
    with reference_precision():
        return _reference(cell, seed, rows, device, arith)


def _reference(cell, seed: int, rows: tuple, device, arith) -> dict:
    wg, wd = seeded_weights(cell, seed, device)
    pg = {k: v.clone().requires_grad_(True) for k, v in wg.items()}
    pd = {k: v.clone().requires_grad_(True) for k, v in wd.items()}
    opt_g, opt_d = pix2pix.adam(pg, cell.config), pix2pix.adam(pd, cell.config)
    losses, grad = [], None
    for rgb, nir in rows:
        x = torch.from_numpy(rgb).to(device)
        y = torch.from_numpy(nir).to(device)
        losses.append(pix2pix.train_step(pg, pd, opt_g, opt_d, x, y, cell.config, arith,
                                         int(cell.settings.get("reference_chunk", 4))))
        if grad is None:
            grad = leaf_norms({**{f"G.{k}": v.grad for k, v in pg.items()},
                               **{f"D.{k}": v.grad for k, v in pd.items()}})
    change = leaf_norms({**{f"G.{k}": pg[k] - wg[k] for k in pg},
                         **{f"D.{k}": pd[k] - wd[k] for k in pd}})
    return {"losses": losses, "grad": grad, "change": change}


class Session:
    """The program's training object for one seed: the task with the
    seeded weights bound, its train state and the feed, driven through the
    reference's steps (their losses, first gradients and changes kept in
    ``prog``, their rows in ``rows``)."""

    def __init__(self, cell, seed: int, device):
        from nirgan_tpu_torch.config import tpu_section
        from nirgan_tpu_torch.data.datasets import NpzFolderDataset, center_crop_chw
        from nirgan_tpu_torch.data.pipeline import DeviceFeed
        from nirgan_tpu_torch.data.select_dataset import DataModule
        from nirgan_tpu_torch.tasks.px2px import Px2PxTask

        self.device = device = torch.device(device)
        s = cell.settings
        cfg = program_config(cell)
        self.batch = batch = int(cfg.Data.train_batch_size)
        self.log_every = int(s.get("log_every", 10))
        self.task = task = Px2PxTask(cfg, device=device, seed=seed)
        w0 = seeded_weights(cell, seed, device)
        task.netG.load_state_dict(w0[0], strict=True)
        task.netD.load_state_dict(w0[1], strict=True)
        self.data = traffic_mod.PairedTiles(
            cell.traffic, weights.subseed(seed, 3), device, seed,
            NpzFolderDataset._to_reflectance, center_crop_chw)
        workers = int(s.get("num_workers", cfg.Data.num_workers))
        dm = DataModule(self.data, None, batch, int(cfg.Data.val_batch_size),
                        num_workers=workers, seed=seed)
        drawn: list = []  # the tiles of each batch, in the order the loader makes them

        def transform(b):
            drawn.append(b["tile"].copy())
            return task.embed_coords(b)

        depth = int(tpu_section(cfg).get("prefetch_depth", 0))

        def batches():
            while True:  # a new loader and feed an epoch, as Trainer.fit makes them
                yield from DeviceFeed(dm.train_dataloader(transform), task.extract_batch,
                                      depth=depth)

        self.feed = batches()
        self.state = task.init_state()
        self.failed = 0
        self.pending = None  # the last pull, read at the next one
        idle = Spans(on=False)
        n_ref = int(s.get("reference_steps", 3))
        prog = {"losses": []}
        for i in range(n_ref):
            m = self.step(idle)
            prog["losses"].append(tuple(float(v) for v in _pull(m)))
            if i == 0:
                prog["grad"] = program_grads(task, self.state, float(cfg.base_configs.beta1))
        prog["change"] = changes(task, w0)
        self.prog = prog
        self.rows = [np.asarray(t) for t in drawn[:n_ref]]
        if len(np.unique(np.concatenate(self.rows))) != n_ref * batch:
            raise core.BenchError("the reference's steps repeat a row")

    def step(self, spans: Spans) -> dict:
        with spans("feed"):
            b = next(self.feed)
        with spans("train_step"):
            m = self.task.train_step(self.state, b)
        if self.state.step % self.log_every == 0:
            with spans("pull"):
                self.settle()
                self.pending = _pull_late(m)
        return m

    def settle(self) -> None:
        """Read the last pull, waiting for its copy alone, and count it
        failed if a loss is not finite."""
        if self.pending is None:
            return
        host, done = self.pending
        if done is not None:
            done.synchronize()
        self.failed += int(not np.all(np.isfinite(host.numpy())))
        self.pending = None

    def close(self) -> None:
        """Stop the feed and drop the program's objects."""
        self.feed.close()
        self.feed = self.task = self.state = None
        release(self.device)


def judge(cell, seed: int, session: Session, device, detail: bool = False) -> dict:
    """The compared numbers of a session whose program is closed; with
    ``detail`` also the three worst leaves of each gap."""
    ref = reference(cell, seed, [session.data.rows(r) for r in session.rows], device)
    out = readings(session.prog, ref)
    if detail:
        gaps = leaf_gaps(session.prog, ref)
        out["losses"] = {"program": session.prog["losses"], "reference": ref["losses"]}
        for what in ("grad", "change"):
            out[f"worst_{what}"] = sorted(([k, *v] for k, v in gaps[what].items()),
                                          key=lambda r: -r[1])[:3]
        out["worst_leaf_change"] = sorted(
            ([k, abs(p - r) / r, p, r] for k, (_, p, r) in gaps["change"].items()),
            key=lambda r: -r[1])[:3]
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> core.Run:
    device = torch.device(device)
    s = cell.settings
    marks = [("imports", time.perf_counter() - t_start)]
    sess = Session(cell, seed, device)
    marks.append(("session", time.perf_counter() - t_start))
    idle = Spans(on=False)
    while sess.state.step < int(s["warmup_steps"]):
        sess.step(idle)
    synchronize(device)
    sess.settle()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))

    spans, clock = Spans(), StepClock(device)
    n = 0
    clock.start()
    t0 = time.perf_counter()
    while True:
        sess.step(spans)
        clock.step()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(device)
    window_s = time.perf_counter() - t0
    step_ms = clock.intervals_ms()
    sess.settle()

    dtrace = None
    if trace:
        k = int(s["trace_steps"])
        annotated = Spans(annotate=True)

        def traced() -> int:
            for _ in range(k):
                sess.step(annotated)
            return k

        dtrace = trace_mod.profile(traced, device)
        sess.settle()
    peak = memory_peak(device)
    failed = sess.failed
    sess.close()

    got = judge(cell, seed, sess, device)
    checks = {k: (got[k], limit) for k, limit in cell.limits.items()}
    batch = sess.batch
    return core.Run(
        end_to_end={"train_images_per_s": n * batch / window_s,
                    "train_step_p95_ms": p95(step_ms), "setup_s": setup_s},
        window_s=window_s, units=n, work=n * batch, attempted=n, failed=failed,
        memory_peak_bytes=peak, checks=checks, spans=spans.totals, trace=dtrace,
        marks=marks,
        shapes=shapes(cell, batch, int(cell.traffic["tile"])))
