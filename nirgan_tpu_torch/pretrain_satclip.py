"""SatCLIP pretraining CLI on the PyTorch port, counterpart of the root
``pretrain_satclip.py`` (the runnable form of the reference's LightningCLI
entry point, ``model/satclip/main.py:112-167``), with the same argv plus the
device:

    python -m nirgan_tpu_torch.pretrain_satclip --data data/s100k_npz --steps 10000
    python -m nirgan_tpu_torch.pretrain_satclip --pack data/s100k_npz --data data/s100k_packed
    python -m nirgan_tpu_torch.pretrain_satclip --fake-geo --steps 50   # smoke mode

It trains on one device (``--device cuda``, the default, or ``cpu``) and
writes ``<out>/satclip.ckpt`` (the reference's Lightning layout: a
``model.``-prefixed ``state_dict`` and ``hyper_parameters``) with the
``satclip_hparams.json`` sidecar, which ``SatClipWrapper`` and the inject
GAN's ``satclip_path: <out>`` read.  Metrics go to ``<out>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


class EveryNth:
    """Deterministic 1-in-``mod`` holdout (the reference's S2GeoDataModule
    splits train and val when it is built; its sampling policy is not in
    the public snapshot): the items whose index is ``offset`` modulo
    ``mod`` when ``keep``, the others when not."""

    def __init__(self, base, offset: int, mod: int, keep: bool):
        self.base = base
        self.idx = [i for i in range(len(base)) if (i % mod == offset) == keep]

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.base[self.idx[i]]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="SatCLIP pretraining on the PyTorch port, on one device "
                    "(the JAX CLI's data-parallel mesh is not ported: ROADMAP "
                    "A11).")
    p.add_argument("--data", default=None,
                   help="folder of .npz tiles or packed shards (image+point)")
    p.add_argument("--pack", default=None, metavar="SRC",
                   help="pack the .npz tiles under SRC into shards at --data "
                        "and exit")
    p.add_argument("--tiles-per-shard", type=int, default=1024)
    p.add_argument("--fake", action="store_true", help="procedural smoke dataset")
    p.add_argument("--fake-geo", action="store_true",
                   help="procedural dataset with coordinate-dependent imagery "
                        "(a real contrastive signal; pairs with FakeDataset geo "
                        "mode for the pretrain-to-inject workflow)")
    p.add_argument("--fake-length", type=int, default=0,
                   help="tiles in the procedural dataset (default 4x batch)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--prefetch-depth", type=int, default=0,
                   help="batches DeviceFeed prepares ahead on a producer "
                        "thread; 0 = in line")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--vision", default="resnet",
                   choices=["resnet", "vit", "moco_resnet18", "moco_resnet50",
                            "moco_vit16"])
    p.add_argument("--tower-weights", default=None,
                   help="timm/torchgeo SSL4EO .pth to warm-start a moco_* tower")
    p.add_argument("--vision-width", type=int, default=64)
    p.add_argument("--resnet-layers", type=int, nargs=4, default=(3, 4, 6, 3))
    p.add_argument("--vit-layers", type=int, default=12)
    p.add_argument("--le-type", default="sphericalharmonics")
    p.add_argument("--pe-type", default="siren")
    p.add_argument("--legendre-polys", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--accumulate", type=int, default=1,
                   help="gradient-accumulation micro-batches per optimizer "
                        "update (the reference trainer defaults to 16, "
                        "main.py:131)")
    p.add_argument("--val-every", type=int, default=0,
                   help=">0: hold out every 20th tile and log val_loss every "
                        "N steps (the reference logs val_loss per epoch)")
    p.add_argument("--val-batches", type=int, default=5)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help=">0: save the checkpoint every N steps (besides the "
                        "final save)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default="logs/satclip_pretrain")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Run the CLI; returns the checkpoint's path (or the packed folder)."""
    args = parse_args(argv)

    from nirgan_tpu_torch.data.pipeline import DeviceFeed, Loader
    from nirgan_tpu_torch.data.s2geo import (FakeS2GeoDataset, PackedS2GeoDataset,
                                             S2GeoDataset, pack_s2geo_shards)

    if args.pack:
        if not args.data:
            raise SystemExit("--pack requires --data as the output folder")
        src = S2GeoDataset(args.pack, augment=False, crop=1 << 30)
        n = pack_s2geo_shards(src, args.data, tiles_per_shard=args.tiles_per_shard)
        print(f"packed {len(src)} tiles into {n} shards under {args.data}")
        return args.data
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")

    from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask
    from nirgan_tpu_torch.utils.loggers import ExperimentLogger

    if args.vision == "resnet":
        vision_layers = tuple(args.resnet_layers)
    elif args.vision == "vit":
        vision_layers = args.vit_layers
    else:
        vision_layers = args.vision  # moco_* pretrained tower
    task = SatClipPretrainTask(
        embed_dim=args.embed_dim, le_type=args.le_type, pe_type=args.pe_type,
        legendre_polys=args.legendre_polys, vision_layers=vision_layers,
        vision_width=args.vision_width, image_resolution=args.image_size,
        learning_rate=args.lr, accumulate_grad_batches=args.accumulate,
        device=args.device)

    if args.fake or args.fake_geo or not args.data:
        ds = FakeS2GeoDataset(length=args.fake_length or max(args.batch_size * 4, 64),
                              crop=args.image_size, channels=task.in_channels,
                              mode="geo" if args.fake_geo else "rand")
        if not (args.fake or args.fake_geo):
            print("no --data given; using the procedural smoke dataset")
    else:
        packed = any(f.endswith(".images.npy") for f in os.listdir(args.data))
        ds = (PackedS2GeoDataset(args.data, crop=args.image_size) if packed
              else S2GeoDataset(args.data, crop=args.image_size))

    state = task.init_state()
    if args.tower_weights:
        task.load_tower_weights(args.tower_weights)
    logger = ExperimentLogger(args.out)

    val_loader = None
    if args.val_every:
        train_ds = EveryNth(ds, 0, 20, keep=False)
        val_ds = EveryNth(ds, 0, 20, keep=True)
        val_loader = Loader(val_ds, min(args.batch_size, max(len(val_ds), 1)),
                            shuffle=False, drop_last=True)
    else:
        train_ds = ds
    loader = Loader(train_ds, args.batch_size, shuffle=True,
                    num_workers=4, drop_last=True)
    if len(loader) == 0:
        raise ValueError(f"{len(train_ds)} tiles make no batch of {args.batch_size}")

    n, t0 = 0, time.time()
    try:
        while n < args.steps:
            for ex in DeviceFeed(loader, task.extract_batch, depth=args.prefetch_depth):
                m = task.train_step(state, ex)
                n += 1
                if n % 10 == 0 or n == 1:
                    loss = float(m["train_loss"])
                    logger.log_metrics({"train_loss": loss}, n)
                    print(json.dumps({"step": n, "train_loss": round(loss, 4),
                                      "elapsed_s": round(time.time() - t0, 1)}),
                          flush=True)
                if val_loader is not None and n % args.val_every == 0:
                    losses = [float(task.eval_step(task.extract_batch(vb))["val_loss"])
                              for vb, _ in zip(val_loader, range(args.val_batches))]
                    if losses:
                        v = float(np.mean(losses))
                        logger.log_metrics({"val_loss": v}, n)
                        print(json.dumps({"step": n, "val_loss": round(v, 4)}),
                              flush=True)
                if args.ckpt_every and n % args.ckpt_every == 0:
                    task.save(args.out)
                if n >= args.steps:
                    break
    finally:
        logger.close()
    path = task.save(args.out)
    print("saved the checkpoint to", path)
    return path


if __name__ == "__main__":
    main()
