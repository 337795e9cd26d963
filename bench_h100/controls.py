"""The readings the limits of ``workloads/<cell>.json`` are set from, many
seeds in one process, at the cell's own sizes:

    python3 -m bench_h100.controls --workload <cell> --what program --seeds 1 2 3
    python3 -m bench_h100.controls --workload <cell> --what control --seeds 1 2 3

``program``: the program's compared numbers on each seed, from the same
session the cell's runs use (its set-up and, for serving, ``batches``
batches or scenes), judged by the plain reference; with ``--fault`` a
fault planted in the program first (``FAULTS``).  ``control``: the
reference in the program's place, computed with float8 e4m3 operands (the
precision below the configuration's bfloat16; the scene's tower in float32
below the program's float64), judged by the plain reference on the same
rows, tiles or windows.  One JSON line a seed.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from bench_h100 import core, traffic as traffic_mod, weights
from bench_h100.drivers import scene, serve, train
from bench_h100.reference import pix2pix
from bench_h100.reference import satclip as ref_satclip
from bench_h100.reference import serve as ref_serve
from bench_h100.timing import Spans


def _no_crop(img, size):
    return img


def _half_batch(step):
    """Half of the batch left out: the step's means over the rest."""
    def half(self, state, batch):
        n = batch["rgb"].shape[0] // 2
        return step(self, state, {k: v[:n] for k, v in batch.items()})
    return half


def _unchanged(step):
    """A step that leaves the parameters as it found them."""
    def unchanged(self, state, batch):
        params = [p for net in (self.netG, self.netD) for p in net.parameters()]
        before = [p.detach().clone() for p in params]
        out = step(self, state, batch)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    return unchanged


def _frozen(net: str, leaf: str):
    """A step that leaves one leaf of ``net`` where it was."""
    def wrap(step):
        def frozen(self, state, batch):
            p = dict(getattr(self, net).named_parameters())[leaf]
            before = p.detach().clone()
            out = step(self, state, batch)
            with torch.no_grad():
                p.copy_(before)
            return out
        return frozen
    return wrap


def _zeroed(embed):
    """The tower's embeddings zeroed where they are made."""
    def zeroed(self, coords):
        return torch.zeros_like(embed(self, coords))
    return zeroed


def _swapped(embed):
    """Each window's longitude and latitude swapped before the tower."""
    def swapped(self, coords):
        return embed(self, np.ascontiguousarray(np.asarray(coords)[:, ::-1]))
    return swapped


def _skipped(inject):
    """The inject left out: the feature map passes unchanged."""
    def skipped(self, h, embeds):
        return h
    return skipped


def _task():
    from nirgan_tpu_torch.tasks.px2px import Px2PxTask

    return Px2PxTask


def _generator():
    from nirgan_tpu_torch.models.generator import ResnetGenerator

    return ResnetGenerator


# fault -> (the driver of the cells it breaks, the program's class, its method, the wrapper)
FAULTS = {
    "half": ("train", _task, "train_step", _half_batch),
    "unchanged": ("train", _task, "train_step", _unchanged),
    "freeze_d": ("train", _task, "train_step", _frozen("netD", "conv4.weight")),
    "freeze_g": ("train", _task, "train_step", _frozen("netG", "c1.weight")),
    "zero_embeds": ("scene", _task, "_embed", _zeroed),
    "swap_lonlat": ("scene", _task, "_embed", _swapped),
    "skip_inject": ("scene", _generator, "_inject", _skipped),
}


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` (a key of ``FAULTS``) while the block
    runs; None plants nothing."""
    if fault is None:
        yield
        return
    _, owner, name, wrap = FAULTS[fault]
    cls = owner()
    method = getattr(cls, name)
    setattr(cls, name, wrap(method))
    try:
        yield
    finally:
        setattr(cls, name, method)


def program(cell, seed: int, device, batches: int, detail: bool = False) -> dict:
    if cell.driver == "train":
        sess = train.Session(cell, seed, device)
        sess.close()
        return train.judge(cell, seed, sess, device, detail)
    mod = serve if cell.driver == "serve" else scene
    sess = mod.Session(cell, seed, device)
    idle = Spans(on=False)
    for _ in range(batches):
        sess.one(idle, True)
    if cell.driver == "serve":
        sess.flush(idle, True)
    sess.close()
    return mod.judge(cell, seed, sess, device)


def control(cell, seed: int, device) -> dict:
    """The reference one precision down in the program's place: float8
    operands for the bfloat16 configurations, an int4 trunk for the int8
    serving one."""
    if cell.driver == "train":
        data = traffic_mod.PairedTiles(cell.traffic, weights.subseed(seed, 3), device,
                                       seed, None, _no_crop)
        b = int(cell.config["Data"]["train_batch_size"])
        n = int(cell.settings.get("reference_steps", 3))
        rows = [data.rows(np.arange(i * b, (i + 1) * b) % len(data.tiles))
                for i in range(n)]
        low = train.reference(cell, seed, rows, device, pix2pix.FP8)
        return train.readings(low, train.reference(cell, seed, rows, device))
    if cell.driver == "scene":
        data = traffic_mod.Scene(cell.traffic, weights.subseed(seed, 3), device)
        tower = ref_satclip.siren_weights(weights.subseed(seed, 5), device)
        low = scene.reference(cell, seed, data, tower, device, pix2pix.FP8)
        want = scene.reference(cell, seed, data, tower, device)
        taps = scene.reference_taps(cell, seed, data, tower, device, pix2pix.FP8, np.float32)
        return {"rel_rmse": ref_serve.worst_rel_rmse(low[None], want[None]),
                **scene.tap_gaps({k: [v] for k, v in taps.items()},
                                 scene.reference_taps(cell, seed, data, tower, device))}
    data = traffic_mod.SRTiles(cell.traffic, weights.subseed(seed, 3), device)
    ids = np.random.default_rng(weights.subseed(seed, 4)).choice(
        len(data.hr), int(cell.settings["sample"]), replace=False)
    if cell.config.get("tpu", {}).get("serving_quant", "none") == "int8":
        low = serve.reference(cell, seed, data, ids, device, pix2pix.PLAIN, bits=4)
    else:
        low = serve.reference(cell, seed, data, ids, device, pix2pix.FP8)
    return {"rel_rmse": ref_serve.worst_rel_rmse(low, serve.reference(cell, seed, data,
                                                                       ids, device))}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m bench_h100.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--what", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=40,
                   help="serving batches or scenes a seed (program)")
    p.add_argument("--detail", action="store_true",
                   help="training: the losses and the worst leaves too (program)")
    p.add_argument("--fault", choices=sorted(FAULTS),
                   help="plant this fault in the program (program)")
    args = p.parse_args(argv)
    core.set_cache_dirs()
    cell = core.load_cell(core.load_benchmark(), args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        with planted(args.fault):
            got = (program(cell, seed, device, args.batches, args.detail)
                   if args.what == "program" else control(cell, seed, device))
        print(json.dumps({"workload": cell.name, "what": args.what, "fault": args.fault,
                          "seed": seed,
                          "device": torch.cuda.get_device_name(0), **got}), flush=True)


if __name__ == "__main__":
    main()
