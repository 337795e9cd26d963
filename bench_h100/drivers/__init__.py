"""The loops that drive a cell, one module a kind of loop, named by the
``driver`` of the cell's ``workloads/<cell>.json``."""

from __future__ import annotations

import contextlib
import gc

import torch

from bench_h100 import weights
from bench_h100.reference import pix2pix


def program_config(cell):
    """The cell's configuration as the program's config tree."""
    from nirgan_tpu_torch.config import from_dict

    return from_dict({k: v for k, v in cell.config.items() if k != "benchmark"})


def seeded_weights(cell, seed: int, device) -> tuple:
    """(G, D) weights from ``seed``: the benchmark's own, made on the
    device, for the program and the reference alike."""
    scalars = {}
    if pix2pix.inject(cell.config):
        scalars["scale_param"] = float(cell.config["satclip"].get("scaling_param_init", 0.01))
    gain = float(cell.config["base_configs"].get("init_gain", 0.02))
    g = weights.make(pix2pix.generator_shapes(cell.config), weights.subseed(seed, 1),
                     device, gain, scalars)
    d = weights.make(pix2pix.discriminator_shapes(cell.config),
                     weights.subseed(seed, 2), device, gain)
    return g, d


def shapes(cell, batch: int, tile: int) -> dict:
    """What the FLOP and byte counts need of a cell."""
    bc, data = cell.config["base_configs"], cell.config["Data"]
    pad = int(data["padding_amount"]) if data["padding"] else 0
    tpu = cell.config.get("tpu", {})
    return {"batch": batch, "tile": tile, "side": tile + 2 * pad,
            "ngf": bc["ngf"], "ndf": bc["ndf"], "n_blocks": pix2pix.n_blocks(cell.config),
            "n_layers_D": bc.get("n_layers_D", 3), "input_nc": bc["input_nc"],
            "output_nc": bc["output_nc"], "inject": pix2pix.inject(cell.config),
            "int8_trunk": tpu.get("serving_quant", "none") == "int8"}


def memory_peak(device) -> int:
    device = torch.device(device)
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device) -> None:
    """After the program's objects are dropped: collect them and return
    their memory, so the reference has the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def reference_precision():
    """float32 with TF32 off for every convolution and matrix product the
    reference runs in the block; the settings before it come back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
