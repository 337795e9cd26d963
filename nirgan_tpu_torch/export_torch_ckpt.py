"""Export a checkpoint of the port's trainer as a reference-loadable torch
``.ckpt``, counterpart of the root ``export_torch_ckpt.py`` (the reverse of
the ``--ckpt`` / ``weights_path`` loader):

    python -m nirgan_tpu_torch.export_torch_ckpt \
        --config configs/config_px2px.yaml --ckpt logs/<project>/<run> \
        --out nirgan_model.ckpt [--no-discriminator]

``--ckpt`` is a run directory (its ``best.pt``, else ``last.pt``) or one
of those files.  The written file holds ``{"state_dict": {netG.*,
netD.*}}`` in the reference's ``nn.Sequential`` layout
(``model/networks.py:341-370``), the key set the JAX package's exporter
writes (``weights.export_reference_weights``).  It reads and writes files
only: no device is involved.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/config_px2px.yaml")
    p.add_argument("--ckpt", required=True,
                   help="a run dir of the port's trainer, or its best.pt / last.pt")
    p.add_argument("--out", default="exported_model.ckpt")
    p.add_argument("--no-discriminator", action="store_true",
                   help="export the generator only")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)

    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.train.checkpoint import run_checkpoint
    from nirgan_tpu_torch.weights import export_reference_weights

    config = load_config(args.config)
    path = run_checkpoint(args.ckpt)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(blob, dict) and "G" in blob and "step" in blob):
        raise ValueError(f"{path}: not a checkpoint of the port's trainer "
                         "(no 'G' and 'step')")
    netD = None if args.no_discriminator else blob.get("D")
    state_dict = export_reference_weights(blob["G"], netD, config)
    torch.save({"state_dict": state_dict}, args.out)
    towers = "netG" + ("+netD" if netD is not None else "")
    print(f"wrote {towers} of {path} (step {blob['step']}) to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
