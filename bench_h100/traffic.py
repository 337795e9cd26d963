"""The general traffic generator: a mix's file (``traffic/<name>.json``)
gives its parameters, the seed gives its data.

``PairedTiles`` (training): ``distinct`` tiles of ``bands`` x
``tile``^2 uint16 DN (RGB then NIR), band b uniform on [0, ``dn_max[b]``),
served by a dataset of ``length`` items whose i-th drawn item (in the
loader's own shuffled order) is tile i mod ``distinct``, so every run of
``distinct`` consecutive rows differs.

``SRTiles`` (bulk serving): ``distinct`` pairs of an HR RGB tile
(3 x ``tile``^2) and an LR RGBN tile (4 x ``lr_tile``^2), each uint16 DN
band uniform on [0, ``dn_max[b]``) (the HR RGB under the first three), in a
dataset of ``length`` items in order, item i the pair i mod ``distinct``.

``Scene`` (whole-scene serving): one 3 x ``side``^2 uint16 DN
scene, band b uniform on [0, ``dn_max[b]``), georeferenced in UTM zone
``epsg`` with its top-left corner at ``origin`` and ``pixel_size`` metres a
pixel, as ``read_geotiff`` describes a Sentinel-2 tile.

The tiles are drawn on the device in one call and copied to the host,
where the program's loaders read them.
"""

from __future__ import annotations

import numpy as np
import torch


def uniform_dn(n: int, dn_max, side: int, gen: torch.Generator, device) -> np.ndarray:
    """(n, len(dn_max), side, side) uint16, band b uniform on [0, dn_max[b])."""
    top = torch.tensor([float(v) for v in dn_max], device=device).view(1, -1, 1, 1)
    u = torch.rand((n, len(dn_max), side, side), generator=gen, device=device)
    return (u * top).to(torch.int16).cpu().numpy().view(np.uint16)


def loader_order(length: int, seed: int) -> np.ndarray:
    """The order in which a shuffling ``Loader`` seeded with ``seed`` draws
    the items of its first epoch (``np.random.default_rng(seed + 1)``)."""
    idx = np.arange(length)
    np.random.default_rng(seed + 1).shuffle(idx)
    return idx


class PairedTiles:
    """The training mix as the S2 datasets' items: {"rgb": (3, H, W),
    "nir": (1, H, W)} f32 reflectance, made from the uint16 tile as the
    program's ``.npy`` tile folders make it; "tile" names the tile, so the
    benchmark can rebuild each batch for the reference."""

    def __init__(self, params: dict, seed: int, device, loader_seed: int,
                 to_reflectance, center_crop):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.tiles = uniform_dn(params["distinct"], params["dn_max"],
                                params["tile"], gen, device)
        self.length = int(params["length"])
        self.side = int(params["tile"])
        self.dn_scale = float(params.get("dn_scale", 10000.0))
        self._to_reflectance, self._crop = to_reflectance, center_crop
        self.tile_of = np.empty(self.length, np.int64)
        self.tile_of[loader_order(self.length, loader_seed)] = (
            np.arange(self.length) % len(self.tiles))

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        t = int(self.tile_of[i])
        img = self._to_reflectance(self.tiles[t], self.dn_scale)
        return {"rgb": self._crop(img[:3], self.side),
                "nir": self._crop(img[3:4], self.side), "tile": t}

    def rows(self, tiles) -> tuple:
        """(rgb, nir) f32 reflectance of the named tiles, (B, 3 | 1, H, W)."""
        x = self.tiles[np.asarray(tiles)].astype(np.float32) / self.dn_scale
        return x[:, :3], x[:, 3:4]


class SRTiles:
    """The serving mix as the program's paired LR/HR dataset items with
    uint16 DN kept: {"lr": (3, h, w), "hr": (3, H, W), "s2_nir": (1, h, w),
    "coords": (2,), "id": str} and "tile"."""

    def __init__(self, params: dict, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        n = params["distinct"]
        self.hr = uniform_dn(n, params["dn_max"][:3], params["tile"], gen, device)
        self.lr = uniform_dn(n, params["dn_max"], params["lr_tile"], gen, device)
        self.length = int(params["length"])
        self.coords = np.zeros(2, np.float32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        t = i % len(self.hr)
        lr = self.lr[t]
        return {"lr": lr[:3], "hr": self.hr[t], "s2_nir": lr[3:4],
                "coords": self.coords, "id": f"tile_{i}", "tile": t}


class Scene:
    """The scene mix: ``rgb`` (3, side, side) uint16 and ``meta``."""

    def __init__(self, params: dict, seed: int, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        side = int(params["side"])
        self.rgb = uniform_dn(1, params["dn_max"], side, gen, device)[0]
        ox, oy = params["origin"]
        size = float(params["pixel_size"])
        self.meta = {"height": side, "width": side, "epsg": int(params["epsg"]),
                     "pixel_scale": (size, size), "tiepoint": (0.0, 0.0, 0.0, ox, oy, 0.0)}
