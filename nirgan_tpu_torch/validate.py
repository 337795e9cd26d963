"""Offline validation / geo-ablation CLI on the PyTorch port, counterpart of
the root ``validate.py`` (reference ``validation_utils/get_results_table.py``
main flow), with the same argv plus the device: sweep a validation dataset
with one or two configs, write the per-sample metric CSV + GeoJSON, and
emit SatCLIP-vs-plain radar comparisons.

    python -m nirgan_tpu_torch.validate --config configs/config_px2px.yaml \
        --max-samples 100
    python -m nirgan_tpu_torch.validate \
        --compare configs/config_px2px_SatCLIP.yaml configs/config_px2px.yaml

``--weights`` takes a reference ``.ckpt`` / ``.pt`` or a run directory of
the port's trainer (its ``best.pt``, else ``last.pt``).
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None, help="single-model sweep")
    p.add_argument("--compare", nargs=2, metavar=("SATCLIP_CFG", "PLAIN_CFG"),
                   default=None, help="two-model sweep + radar plots")
    p.add_argument("--weights", default=None,
                   help="reference .ckpt/.pt or a run dir of the port's "
                        "trainer (--config mode)")
    p.add_argument("--weights-satclip", default=None,
                   help="weights for the SatCLIP model in --compare mode")
    p.add_argument("--weights-plain", default=None,
                   help="weights for the plain model in --compare mode")
    p.add_argument("--out", default="validation_metrics")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--quant", choices=["none", "int8"], default=None,
                   help="override tpu.serving_quant in --config mode: sweep "
                        "the same weights with none vs int8 to check the "
                        "quantised serving mode offline")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the hand-written kernels, cpu their plain "
                        "versions")
    args = p.parse_args(argv)
    if not (args.compare or args.config):
        p.error("give --config or --compare")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")

    from nirgan_tpu_torch.validation.results_table import (
        create_val_metrics,
        run_comparison,
    )

    if args.compare:
        folder, plots = run_comparison(args.compare[0], args.compare[1],
                                       out_root=args.out,
                                       max_samples=args.max_samples,
                                       satclip_weights=args.weights_satclip,
                                       plain_weights=args.weights_plain,
                                       device=args.device)
        print("wrote", folder)
        for pl in plots:
            print("  ", pl)
        return folder, plots
    os.makedirs(args.out, exist_ok=True)
    gdf = create_val_metrics(args.config, args.out, weights_path=args.weights,
                             max_samples=args.max_samples, quant=args.quant,
                             device=args.device)
    print(f"wrote {len(gdf)} per-sample rows to {args.out}")
    return gdf


if __name__ == "__main__":
    main()
