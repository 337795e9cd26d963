"""Training CLI on the PyTorch port, counterpart of the root ``train.py``
(reference ``train.py:17-136``), with the same argv plus the device:

    python -m nirgan_tpu_torch.train --satclip y      # SatCLIP-conditioned (flagship)
    python -m nirgan_tpu_torch.train --satclip n      # plain Pix2Pix cGAN
    python -m nirgan_tpu_torch.train --baseline y     # baseline regressors
    python -m nirgan_tpu_torch.train --config configs/config_px2px.yaml \
        --max-steps 8 --device cuda [--resume RUN_DIR]

Without ``--config`` the flags pick the config as the reference does
(``train.py:32-42``; SatCLIP conditioning is the default,
``configs/config_baselines.yaml`` with ``--baseline y``).  A config whose
``base_configs`` names a ``model_name`` trains ``BaselineTask``, any other
``Px2PxTask`` (``train.py:50-59``).
"""

from __future__ import annotations

import argparse

import torch


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in {"true", "t", "yes", "y", "1"}:
        return True
    if value.lower() in {"false", "f", "no", "n", "0"}:
        return False
    raise argparse.ArgumentTypeError(f"Invalid boolean value: {value}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Training script for NIR-GAN "
                                "(PyTorch port).")
    p.add_argument("--satclip", type=str2bool, default=True,
                   help="SatCLIP conditioning (default: True)")
    p.add_argument("--baseline", type=str2bool, default=False,
                   help="train the baseline regressors (default: False)")
    p.add_argument("--config", default=None,
                   help="explicit config path (overrides flag-based selection)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="resume the full train state from a previous run dir "
                        "(sets Model.load_checkpoint)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the hand-written kernels, cpu their plain "
                        "versions")
    p.add_argument("--logdir", default=None,
                   help="run dir (default logs/<project>/<time stamp>)")
    p.add_argument("--log-every", type=int, default=10,
                   help="steps between train-metric log lines")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")

    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data import dataset_selector
    from nirgan_tpu_torch.tasks import BaselineTask, Px2PxTask
    from nirgan_tpu_torch.train.trainer import Trainer

    if args.config:
        config = load_config(args.config)
    elif args.baseline:
        print("Baseline:", args.baseline)
        config = load_config("configs/config_baselines.yaml")
    else:
        print("Satclip:", args.satclip)
        config = load_config("configs/config_px2px_SatCLIP.yaml" if args.satclip
                             else "configs/config_px2px.yaml")
    if args.resume:
        config.custom_configs.Model.load_checkpoint = args.resume
    kind = (BaselineTask if args.baseline or "model_name" in config.base_configs
            else Px2PxTask)
    task = kind(config, device=args.device, seed=0)
    dm = dataset_selector(config)
    trainer = Trainer(task, dm, config, logdir=args.logdir,
                      max_steps=args.max_steps, log_every=args.log_every)
    print("Experiment Path:", trainer.logdir, flush=True)
    state = trainer.fit()
    trainer.logger.close()
    return state
