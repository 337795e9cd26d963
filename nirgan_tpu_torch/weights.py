"""Weights between the JAX package's parameter trees and the port's
state_dict.

``params_from_jax`` maps a (numpy) flax tree of the plain ``ResnetGenerator``
onto the port's names: conv kernels HWIO -> OIHW, conv-transpose kernels
HWIO -> IOHW with no flip (the inverse of ``_conv`` / ``_convT`` in
``nirgan_tpu/train/torch_convert.py``; its ``_rev_conv`` / ``_rev_convT``
do the same).  ``d_params_from_jax`` does the same for the
``NLayerDiscriminator`` tree.  ``load_reference_weights`` and
``load_reference_ckpt`` read a reference Lightning ``.ckpt`` (``netG.*``,
``netD.*``) through that jax-free converter.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_CONVS = ("c0", "d0", "d1", "c1")
_CONVTS = ("u0", "u1")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _put(out: dict, name: str, p: Mapping, perm: tuple) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), perm))
    if "bias" in p:
        out[f"{name}.bias"] = _tensor(p["bias"])


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params of the plain ResnetGenerator -> the port's state_dict."""
    unknown = [k for k in params
               if k not in _CONVS + _CONVTS and not k.startswith("r")]
    if unknown:
        raise ValueError(f"params of the plain generator expected; unknown "
                         f"entries {unknown} (SatCLIP inject is not ported)")
    out: dict[str, torch.Tensor] = {}
    for name in _CONVS:
        _put(out, name, params[name], (3, 2, 0, 1))
    for name in _CONVTS:
        _put(out, name, params[name], (2, 3, 0, 1))
    blocks = sorted((k for k in params if k.startswith("r")),
                    key=lambda k: int(k[1:]))
    for name in blocks:
        for conv in ("conv1", "conv2"):
            _put(out, f"{name}.{conv}", params[name][conv], (3, 2, 0, 1))
    return out


def d_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params of ``NLayerDiscriminator`` (``conv0`` ... ``conv{n+1}``)
    -> the port's state_dict."""
    names = sorted(params, key=lambda k: int(k[4:]) if k[4:].isdigit() else -1)
    if not names or any(not (k.startswith("conv") and k[4:].isdigit())
                        for k in names):
        raise ValueError(f"params of NLayerDiscriminator expected, got "
                         f"{sorted(params)}")
    out: dict[str, torch.Tensor] = {}
    for name in names:
        _put(out, name, params[name], (3, 2, 0, 1))
    return out


def load_reference_weights(path: str, config) -> dict[str, dict]:
    """The towers of a reference ``Px2Px_PL`` ``.ckpt`` as the port's
    state_dicts: ``{"netG": ..., "netD": ...}``, each key present only when
    the checkpoint holds that network (strict=False warm starts)."""
    from nirgan_tpu.train.torch_convert import convert_px2px_checkpoint

    converted = convert_px2px_checkpoint(path, config)
    out = {}
    if "params_g" in converted:
        out["netG"] = params_from_jax(converted["params_g"])
    if "params_d" in converted:
        if config.base_configs.netD == "pixel":
            raise NotImplementedError("the pixel discriminator is not ported "
                                      "yet")
        out["netD"] = d_params_from_jax(converted["params_d"])
    return out


def load_reference_ckpt(path: str, config) -> dict[str, torch.Tensor]:
    """Generator state_dict from a reference ``Px2Px_PL`` ``.ckpt``."""
    loaded = load_reference_weights(path, config)
    if "netG" not in loaded:
        raise ValueError(f"{path}: no netG.* weights in the checkpoint")
    return loaded["netG"]
