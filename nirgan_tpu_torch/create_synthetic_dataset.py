"""Bulk RGB->NIR synthesis CLI on the PyTorch port, counterpart of the root
``create_synthetic_dataset.py``: load a reference checkpoint (or serve
random weights), sweep an LR/HR paired dataset, histogram-match the
predictions to the S2 NIR reference, write fp16 ``.npz`` tiles.

    python -m nirgan_tpu_torch.create_synthetic_dataset \
        --data data/synthDataset --ckpt ckpts/S2.ckpt --device cuda

With a SatCLIP config (``--config configs/config_px2px_SatCLIP.yaml``) each
tile's coordinates condition the generator.  ``--quant int8`` (or
``tpu.serving_quant: int8`` in the config) serves the residual trunk in
int8 on kernels D and E, calibrated on the first batch.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/config_px2px.yaml")
    p.add_argument("--ckpt", default="ckpts/S2.ckpt",
                   help="reference torch .ckpt (random weights if absent)")
    p.add_argument("--data", default="data/synthDataset")
    p.add_argument("--out", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-hist-match", action="store_true")
    p.add_argument("--plot-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda runs the hand-written kernels")
    p.add_argument("--mesh", action="store_true", help="not ported yet")
    p.add_argument("--quant", choices=["none", "int8"], default=None,
                   help="serving quantisation, overrides tpu.serving_quant: "
                        "int8 runs the residual trunk on the int8 kernels")
    args = p.parse_args(argv)
    if args.mesh:
        p.error("--mesh: multi-device serving is not ported yet")
    if args.ckpt and os.path.isdir(args.ckpt):
        p.error(f"--ckpt {args.ckpt}: orbax checkpoint directories need the "
                "JAX package; pass a reference .ckpt file")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")

    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data.datasets import SRPairedDataset
    from nirgan_tpu_torch.inference import synthesize_dataset
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.weights import load_reference_ckpt

    config = load_config(args.config)
    if "model_name" in config.base_configs:
        # the JAX CLI builds the GAN task alone, which a baseline config
        # cannot make
        raise ValueError(f"{args.config}: a baseline config; the bulk synthesis "
                         "serves the GAN generator (baselines serve through "
                         "BaselineTask.predict_step)")
    if args.quant is not None:
        # reference-schema configs have no tpu: section: create it
        config["tpu"] = config.get("tpu") or {}
        config.tpu.serving_quant = args.quant
    task = Px2PxTask(config, device=device, seed=0)
    if args.ckpt and os.path.exists(args.ckpt):
        task.bind(load_reference_ckpt(args.ckpt, config))
        print("Loaded weights from:", args.ckpt)
    else:
        print(f"WARNING: checkpoint {args.ckpt!r} not found - running with "
              "random weights (smoke mode)")

    # uint16 DN rasters reach the device unscaled (half the copy bytes);
    # serving scales DN/10000 there
    dataset = SRPairedDataset(args.data, dn_passthrough=True)
    out = args.out or os.path.join(args.data, "synth_nirs")
    n = synthesize_dataset(task, dataset, out, batch_size=args.batch_size,
                           match_histograms=not args.no_hist_match,
                           plot_dir=args.plot_dir)
    print(f"wrote {n} synthetic NIR tiles to {out}")
    return n


if __name__ == "__main__":
    main()
