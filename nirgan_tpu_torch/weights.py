"""Weights between the JAX package's parameter trees and the port's
state_dict.

``params_from_jax`` maps a (numpy) flax tree of ``ResnetGenerator``, plain
or inject, onto the port's names: conv kernels HWIO -> OIHW, conv-transpose
kernels HWIO -> IOHW with no flip, the inject variant's dense ``fc`` kernel
(in, out) -> (out, in) and its two scalars as they are (the inverse of
``_conv`` / ``_convT`` / ``_dense`` in ``nirgan_tpu/train/torch_convert.py``;
its ``_rev_*`` do the same).  ``d_params_from_jax`` does the same for the
``NLayerDiscriminator`` tree.  ``load_reference_weights`` and
``load_reference_ckpt`` read a reference Lightning ``.ckpt`` (``netG.*``,
``netD.*``) directly: its tensors are torch's layout already, so only the
``nn.Sequential`` indices are mapped onto the port's layer names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_CONVS = ("c0", "d0", "d1", "c1")
_CONVTS = ("u0", "u1")
# the inject variant's extras, under the reference's state_dict names
# (``model/generator_inject.py:88-100``)
_SCALARS = ("scale_param", "post_correction_param")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _put(out: dict, name: str, p: Mapping, perm: tuple) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), perm))
    if "bias" in p:
        out[f"{name}.bias"] = _tensor(p["bias"])


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params of ``ResnetGenerator`` (plain or inject) -> the port's
    state_dict."""
    unknown = [k for k in params
               if k not in _CONVS + _CONVTS + _SCALARS + ("fc",)
               and not (k[:1] == "r" and k[1:].isdigit())]
    if unknown:
        raise ValueError(f"params of ResnetGenerator expected; unknown "
                         f"entries {unknown}")
    out: dict[str, torch.Tensor] = {}
    for name in _CONVS:
        _put(out, name, params[name], (3, 2, 0, 1))
    for name in _CONVTS:
        _put(out, name, params[name], (2, 3, 0, 1))
    blocks = sorted((k for k in params if k[:1] == "r" and k[1:].isdigit()),
                    key=lambda k: int(k[1:]))
    for name in blocks:
        for conv in ("conv1", "conv2"):
            _put(out, f"{name}.{conv}", params[name][conv], (3, 2, 0, 1))
    if "fc" in params:
        _put(out, "fc", params["fc"], (1, 0))
    for name in _SCALARS:
        if name in params:
            out[name] = _tensor(params[name])
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


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A torch or Lightning ``.ckpt`` as a flat {key: array} dict (the
    port's copy of ``load_torch_state_dict`` in
    ``nirgan_tpu/train/torch_convert.py``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()
            if hasattr(v, "detach")}


def _resnet_generator_keys(n_blocks: int, use_dropout: bool) -> dict[str, str]:
    """The port's layer names -> the reference ``ResnetGenerator``'s
    ``nn.Sequential`` indices (``model/networks.py:341-370``, instance norm:
    1 stem conv7, 4 and 7 the stride-2 convs, 10.. the blocks with convs at
    ``conv_block.1`` and ``.5`` (``.6`` with dropout), then the two
    transposed convs and the head conv7), as ``convert_resnet_generator``
    maps them."""
    blk0 = 10
    up0 = blk0 + n_blocks
    conv2 = 6 if use_dropout else 5
    keys = {"c0": "model.1", "d0": "model.4", "d1": "model.7",
            "c1": f"model.{up0 + 7}", "u0": f"model.{up0}",
            "u1": f"model.{up0 + 3}"}  # the order of ``params_from_jax``
    for i in range(n_blocks):
        keys[f"r{i}.conv1"] = f"model.{blk0 + i}.conv_block.1"
        keys[f"r{i}.conv2"] = f"model.{blk0 + i}.conv_block.{conv2}"
    return keys


def _nlayer_discriminator_keys(n_layers: int) -> dict[str, str]:
    """The port's ``conv{k}`` -> the reference ``NLayerDiscriminator``'s
    indices (``model/networks.py:557-580``), as
    ``convert_nlayer_discriminator`` maps them."""
    keys = {"conv0": "model.0"}
    for n in range(1, n_layers + 1):
        keys[f"conv{n}"] = f"model.{2 + 3 * (n - 1)}"
    keys[f"conv{n_layers + 1}"] = f"model.{2 + 3 * n_layers}"
    return keys


def _tower(sd: Mapping, prefix: str, keys: Mapping[str, str]) -> dict:
    """Rename one network's conv weights and biases.  The reference's
    tensors are torch's layout already (OIHW, and IOHW for the transposed
    convs), which is the port's: keys change, tensors do not."""
    out: dict[str, torch.Tensor] = {}
    for name, ref in keys.items():
        out[f"{name}.weight"] = _tensor(sd[f"{prefix}{ref}.weight"])
        if f"{prefix}{ref}.bias" in sd:
            out[f"{name}.bias"] = _tensor(sd[f"{prefix}{ref}.bias"])
    return out


def load_reference_weights(path_or_sd, config) -> dict[str, dict]:
    """The towers of a reference ``Px2Px_PL`` ``.ckpt`` (a path, or its
    flat state_dict) as the port's state_dicts: ``{"netG": ..., "netD":
    ...}``, each key present only when the checkpoint holds that network
    (strict=False warm starts)."""
    sd = (load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else path_or_sd)
    bc = config.base_configs
    out = {}
    if any(k.startswith("netG.") for k in sd):
        if bc.netG.startswith("unet"):
            raise NotImplementedError("the U-Net generator is not ported yet")
        out["netG"] = _tower(sd, "netG.", _resnet_generator_keys(
            9 if bc.netG == "resnet_9blocks" else 6, not bc.no_dropout))
        # the inject variant's extras keep their names and layouts
        for name in ("fc.weight", "fc.bias") + _SCALARS:
            if f"netG.{name}" in sd:
                out["netG"][name] = _tensor(sd[f"netG.{name}"])
    if any(k.startswith("netD.") for k in sd):
        if bc.netD == "pixel":
            raise NotImplementedError("the pixel discriminator is not ported "
                                      "yet")
        out["netD"] = _tower(sd, "netD.", _nlayer_discriminator_keys(
            3 if bc.netD == "basic" else bc.n_layers_D))
    return out


def load_reference_ckpt(path: str, config) -> dict[str, torch.Tensor]:
    """Generator state_dict from a reference ``Px2Px_PL`` ``.ckpt``."""
    loaded = load_reference_weights(path, config)
    if "netG" not in loaded:
        raise ValueError(f"{path}: no netG.* weights in the checkpoint")
    return loaded["netG"]
