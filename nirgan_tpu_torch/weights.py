"""Weights between the JAX package's parameter trees and the port's
state_dict.

``params_from_jax`` maps a (numpy) flax tree of a generator onto the port's
names: ``ResnetGenerator``, plain or inject, or ``UnetGenerator`` (its
nested ``unet.sub.sub...`` tree).  Conv kernels HWIO -> OIHW, conv-transpose
kernels HWIO -> IOHW with no flip, the inject variant's dense ``fc`` kernel
(in, out) -> (out, in) and its two scalars as they are (the inverse of
``_conv`` / ``_convT`` / ``_dense`` in ``nirgan_tpu/train/torch_convert.py``;
its ``_rev_*`` do the same); a batch norm's ``bn`` ``scale`` / ``bias``
become ``weight`` / ``bias``, and with ``batch_stats`` its ``mean`` / ``var``
become ``running_mean`` / ``running_var`` (``_bn_split`` in reverse), with
``num_batches_tracked`` 0, which flax does not count.
``d_params_from_jax`` does the same for ``NLayerDiscriminator`` and
``PixelDiscriminator`` trees, ``baseline_params_from_jax`` for the baseline
regressors, ``satclip_params_from_jax`` for a whole SatCLIP model (every
vision tower and location network, ``logit_scale``).

``load_reference_weights`` and ``load_reference_ckpt`` read a reference
Lightning ``.ckpt`` (``netG.*``, ``netD.*``) directly: its tensors are
torch's layout already, so only the ``nn.Sequential`` indices are mapped
onto the port's layer names, batch norms with their buffers.
``load_baseline_weights`` does it for a baseline's ``.ckpt``.
``export_reference_weights`` goes the other way, from the same key tables:
the port's state_dicts as a reference ``state_dict`` (``python -m
nirgan_tpu_torch.export_torch_ckpt`` writes it).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

_CONVS = ("c0", "d0", "d1", "c1")
_CONVTS = ("u0", "u1")
_NORMS = ("n0", "nd0", "nd1", "nu0", "nu1")
# the inject variant's extras, under the reference's state_dict names
# (``model/generator_inject.py:88-100``)
_SCALARS = ("scale_param", "post_correction_param")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _put(out: dict, name: str, p: Mapping, perm: tuple) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), perm))
    if "bias" in p:
        out[f"{name}.bias"] = _tensor(p["bias"])


def _put_norm(out: dict, name: str, p: Optional[Mapping],
              stats: Optional[Mapping]) -> None:
    """A flax ``Norm``'s batch norm (``{"bn": {"scale", "bias"}}`` and its
    ``{"bn": {"mean", "var"}}`` statistics) under the port's names; nothing
    for an instance norm, which has no parameters."""
    if p is not None and "bn" in p:
        out[f"{name}.weight"] = _tensor(p["bn"]["scale"])
        out[f"{name}.bias"] = _tensor(p["bn"]["bias"])
    if stats is not None and "bn" in stats:
        out[f"{name}.running_mean"] = _tensor(stats["bn"]["mean"])
        out[f"{name}.running_var"] = _tensor(stats["bn"]["var"])
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _sub(tree: Optional[Mapping], key: str) -> Optional[Mapping]:
    return None if tree is None else tree.get(key)


def _unet_from_jax(out: dict, prefix: str, params: Mapping,
                   stats: Optional[Mapping]) -> None:
    _put(out, f"{prefix}down", params["down"], (3, 2, 0, 1))
    _put_norm(out, f"{prefix}downnorm", params.get("downnorm"),
              _sub(stats, "downnorm"))
    if "sub" in params:
        _unet_from_jax(out, f"{prefix}sub.", params["sub"], _sub(stats, "sub"))
    _put(out, f"{prefix}up", params["up"], (2, 3, 0, 1))
    _put_norm(out, f"{prefix}upnorm", params.get("upnorm"),
              _sub(stats, "upnorm"))


def params_from_jax(params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> dict[str, torch.Tensor]:
    """Flax params of ``ResnetGenerator`` (plain or inject) or of
    ``UnetGenerator`` [and their ``batch_stats``] -> the port's
    state_dict."""
    out: dict[str, torch.Tensor] = {}
    if "unet" in params:
        _unet_from_jax(out, "unet.", params["unet"], _sub(batch_stats, "unet"))
        return out
    unknown = [k for k in params
               if k not in _CONVS + _CONVTS + _NORMS + _SCALARS + ("fc",)
               and not (k[:1] == "r" and k[1:].isdigit())]
    if unknown:
        raise ValueError(f"params of ResnetGenerator expected; unknown "
                         f"entries {unknown}")
    stats = batch_stats or {}
    for name in _CONVS:
        _put(out, name, params[name], (3, 2, 0, 1))
    for name in _CONVTS:
        _put(out, name, params[name], (2, 3, 0, 1))
    blocks = sorted((k for k in params if k[:1] == "r" and k[1:].isdigit()),
                    key=lambda k: int(k[1:]))
    for name in blocks:
        for conv in ("conv1", "conv2"):
            _put(out, f"{name}.{conv}", params[name][conv], (3, 2, 0, 1))
    for name in _NORMS:
        _put_norm(out, name, params.get(name), stats.get(name))
    for name in blocks:
        for norm in ("norm1", "norm2"):
            _put_norm(out, f"{name}.{norm}", params[name].get(norm),
                      _sub(stats.get(name), norm))
    if "fc" in params:
        _put(out, "fc", params["fc"], (1, 0))
    for name in _SCALARS:
        if name in params:
            out[name] = _tensor(params[name])
    return out


def d_params_from_jax(params: Mapping,
                      batch_stats: Optional[Mapping] = None) -> dict[str, torch.Tensor]:
    """Flax params of ``NLayerDiscriminator`` or ``PixelDiscriminator``
    (``conv0`` ... ``conv{k}``, ``norm1`` ...) [and their ``batch_stats``]
    -> the port's state_dict."""
    def number(k: str, head: str) -> int:
        return int(k[len(head):]) if k[len(head):].isdigit() else -1

    convs = sorted((k for k in params if k.startswith("conv")),
                   key=lambda k: number(k, "conv"))
    norms = sorted((k for k in params if k.startswith("norm")),
                   key=lambda k: number(k, "norm"))
    if not convs or any(number(k, "conv") < 0 for k in convs) or \
            len(convs) + len(norms) != len(params):
        raise ValueError(f"params of a discriminator expected, got "
                         f"{sorted(params)}")
    stats = batch_stats or {}
    out: dict[str, torch.Tensor] = {}
    for name in convs:
        _put(out, name, params[name], (3, 2, 0, 1))
    for name in norms:
        _put_norm(out, name, params[name], stats.get(name))
    return out


def baseline_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params of ``LinearNIR`` / ``MLPNIR`` / ``CNNNIR`` (1x1 and 3x3
    conv kernels, HWIO) -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    for name in sorted(params):
        _put(out, name, params[name], (3, 2, 0, 1))
    return out


def _put_bn(out: dict, name: str, p: Mapping, stats: Optional[Mapping]) -> None:
    """A flax ``BatchNorm`` (``scale``, ``bias`` [, ``mean``, ``var``])
    under torch's batch-norm names."""
    out[f"{name}.weight"] = _tensor(p["scale"])
    out[f"{name}.bias"] = _tensor(p["bias"])
    if stats is not None:
        out[f"{name}.running_mean"] = _tensor(stats["mean"])
        out[f"{name}.running_var"] = _tensor(stats["var"])
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _put_ln(out: dict, name: str, p: Mapping) -> None:
    p = p.get("LayerNorm_0", p)  # CLIP's LayerNorm wraps flax's
    out[f"{name}.weight"] = _tensor(p["scale"])
    out[f"{name}.bias"] = _tensor(p["bias"])


def _conv_bn_tree(out: dict, prefix: str, params: Mapping,
                  stats: Optional[Mapping], renames: Mapping[str, str]) -> None:
    """Every conv and batch norm of a ResNet block or stem: flax name ->
    torch name by ``renames`` (the name itself where absent)."""
    for key, sub in params.items():
        name = f"{prefix}{renames.get(key, key)}"
        if "kernel" in sub and np.ndim(sub["kernel"]) == 4:
            _put(out, name, sub, (3, 2, 0, 1))
        elif "scale" in sub:
            _put_bn(out, name, sub, _sub(stats, key))


_CLIP_BLOCK = {"down_conv": "downsample.0", "down_bn": "downsample.1"}
_TIMM_BLOCK = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _stages(out: dict, prefix: str, params: Mapping, stats: Optional[Mapping],
            renames: Mapping[str, str]) -> None:
    """``layer{s}_{i}`` blocks -> ``layer{s}.{i}``."""
    for key in params:
        if key.startswith("layer") and "_" in key:
            stage, i = key.split("_")
            _conv_bn_tree(out, f"{prefix}{stage}.{i}.", params[key],
                          _sub(stats, key), renames)


def _attention_in_proj(out: dict, name: str, p: Mapping) -> None:
    """flax ``MultiHeadDotProductAttention`` (``query`` / ``key`` /
    ``value`` kernels (d, heads, hd), ``out`` (heads, hd, d)) -> torch's
    fused ``in_proj_weight`` (3d, d) and ``out_proj``."""
    d = np.shape(p["query"]["kernel"])[0]
    ws = [np.reshape(p[k]["kernel"], (d, d)).T for k in ("query", "key", "value")]
    bs = [np.reshape(p[k]["bias"], (d,)) for k in ("query", "key", "value")]
    out[f"{name}.in_proj_weight"] = _tensor(np.concatenate(ws))
    out[f"{name}.in_proj_bias"] = _tensor(np.concatenate(bs))
    out[f"{name}.out_proj.weight"] = _tensor(np.reshape(p["out"]["kernel"], (d, d)).T)
    out[f"{name}.out_proj.bias"] = _tensor(p["out"]["bias"])


def _visual_from_jax(out: dict, params: Mapping, stats: Optional[Mapping]) -> None:
    v = "visual."
    if "attnpool" in params:  # CLIP ModifiedResNet
        _conv_bn_tree(out, v, {k: params[k] for k in
                               ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3")},
                      stats, {})
        _stages(out, v, params, stats, _CLIP_BLOCK)
        pool = params["attnpool"]
        out[f"{v}attnpool.positional_embedding"] = _tensor(pool["positional_embedding"])
        for k in ("q_proj", "k_proj", "v_proj", "c_proj"):
            _put(out, f"{v}attnpool.{k}", pool[k], (1, 0))
    elif "class_embedding" in params:  # CLIP VisionTransformer
        _put(out, f"{v}conv1", params["conv1"], (3, 2, 0, 1))
        for k in ("class_embedding", "positional_embedding", "proj"):
            out[f"{v}{k}"] = _tensor(params[k])
        for k in ("ln_pre", "ln_post"):
            _put_ln(out, f"{v}{k}", params[k])
        blocks = sorted((k for k in params if k.startswith("block")),
                        key=lambda k: int(k[len("block"):]))
        for i, k in enumerate(blocks):
            b, name = params[k], f"{v}transformer.resblocks.{i}"
            _attention_in_proj(out, f"{name}.attn", b["attn"])
            _put_ln(out, f"{name}.ln_1", b["ln_1"])
            _put_ln(out, f"{name}.ln_2", b["ln_2"])
            _put(out, f"{name}.mlp.c_fc", b["c_fc"], (1, 0))
            _put(out, f"{name}.mlp.c_proj", b["c_proj"], (1, 0))
    elif "cls_token" in params:  # timm ViT
        _put(out, f"{v}patch_embed.proj", params["patch_embed_proj"], (3, 2, 0, 1))
        for k in ("cls_token", "pos_embed"):
            out[f"{v}{k}"] = _tensor(params[k])
        blocks = sorted((k for k in params if k.startswith("blocks_")),
                        key=lambda k: int(k[len("blocks_"):]))
        for i, k in enumerate(blocks):
            b, name = params[k], f"{v}blocks.{i}"
            for src, dst in (("attn_qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
                             ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
                _put(out, f"{name}.{dst}", b[src], (1, 0))
            _put_ln(out, f"{name}.norm1", b["norm1"])
            _put_ln(out, f"{name}.norm2", b["norm2"])
        _put_ln(out, f"{v}norm", params["norm"])
        _put(out, f"{v}head", params["head"], (1, 0))
    elif "fc" in params:  # timm ResNet
        _conv_bn_tree(out, v, {k: params[k] for k in ("conv1", "bn1")}, stats, {})
        _stages(out, v, params, stats, _TIMM_BLOCK)
        _put(out, f"{v}fc", params["fc"], (1, 0))
    else:
        raise ValueError(f"unknown SatCLIP vision tower: {sorted(params)}")


def _location_from_jax(out: dict, nnet: Mapping) -> None:
    n = "location.nnet."
    if "kernel" in nnet:  # linear
        _put(out, n.rstrip("."), nnet, (1, 0))
    elif "last_layer" in nnet:  # siren
        i = 0
        while f"layers_{i}" in nnet:
            _put(out, f"{n}layers.{i}", nnet[f"layers_{i}"], (1, 0))
            i += 1
        _put(out, f"{n}last_layer", nnet["last_layer"], (1, 0))
    elif "class_emb" in nnet:  # fcnet
        _put(out, f"{n}feats.0", nnet["Dense_0"], (1, 0))
        for i in range(4):
            for w in ("w1", "w2"):
                _put(out, f"{n}feats.{2 + i}.{w}", nnet[f"res{i}_{w}"], (1, 0))
        _put(out, f"{n}class_emb", nnet["class_emb"], (1, 0))
    elif "Dense_0" in nnet:  # mlp: Dense_i -> features.{2 i}
        i = 0
        while f"Dense_{i}" in nnet:
            _put(out, f"{n}features.{2 * i}", nnet[f"Dense_{i}"], (1, 0))
            i += 1
    else:
        raise ValueError(f"unknown SatCLIP location network: {sorted(nnet)}")


def satclip_params_from_jax(params: Mapping,
                            batch_stats: Optional[Mapping] = None) -> dict[str, torch.Tensor]:
    """Flax params of ``nirgan_tpu``'s ``SatCLIP`` [and its ``batch_stats``]
    -> the port's ``SatCLIP`` state_dict: any vision tower (CLIP ResNet or
    ViT, timm ResNet-18/50 or ViT-S), any location network (siren, mlp,
    fcnet, linear; ``nnet`` -> ``location.nnet``) and ``logit_scale``.
    Conv kernels HWIO -> OIHW, dense (in, out) -> (out, in), flax
    attention's q/k/v kernels into torch's ``in_proj_weight``."""
    out: dict[str, torch.Tensor] = {}
    _visual_from_jax(out, params["visual"], _sub(batch_stats, "visual"))
    _location_from_jax(out, params["nnet"])
    out["logit_scale"] = _tensor(params["logit_scale"])
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
    ``nn.Sequential`` indices (``model/networks.py:341-370``: 1 stem conv7,
    4 and 7 the stride-2 convs, 10.. the blocks with convs at
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


def _resnet_norm_keys(n_blocks: int, use_dropout: bool) -> dict[str, str]:
    """The generator's norms, each the index after its conv's: 2, 5 and 8
    after the stem and the stride-2 convs, ``conv_block.2`` and ``.6``
    (``.7`` with dropout) in a block, one after each transposed conv."""
    up0 = 10 + n_blocks
    norm2 = 7 if use_dropout else 6
    keys = {"n0": "model.2", "nd0": "model.5", "nd1": "model.8",
            "nu0": f"model.{up0 + 1}", "nu1": f"model.{up0 + 4}"}
    for i in range(n_blocks):
        keys[f"r{i}.norm1"] = f"model.{10 + i}.conv_block.2"
        keys[f"r{i}.norm2"] = f"model.{10 + i}.conv_block.{norm2}"
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


def _nlayer_norm_keys(n_layers: int) -> dict[str, str]:
    """``norm{k}``, each the index after ``conv{k}``."""
    return {f"norm{n}": f"model.{3 + 3 * (n - 1)}" for n in range(1, n_layers + 1)}


# the reference ``PixelDiscriminator``'s ``net`` (``model/networks.py:
# 604-612``): conv, LeakyReLU, conv, norm, LeakyReLU, conv
_PIXEL_KEYS = {"conv0": "net.0", "conv1": "net.2", "conv2": "net.5"}
_PIXEL_NORM_KEYS = {"norm1": "net.3"}


def _unet_keys(num_downs: int) -> tuple[dict[str, str], dict[str, str],
                                        dict[str, str]]:
    """(convs, transposed convs, norms) of the reference ``UnetGenerator``
    (``model/networks.py:504-530``), as ``convert_unet_generator`` walks
    them: the outermost block is [down 0, sub 1, relu, up 3, tanh], a
    middle one [lrelu, down 1, norm 2, sub 3, relu, up 5, norm 6
    (, dropout)], the innermost [lrelu, down 1, relu, up 3, norm 4]."""
    convs, convts, norms = {}, {}, {}
    # the generator's ``model`` is the outermost block, whose own ``model``
    # is its ``nn.Sequential``
    name, ref = "unet.", "model.model."
    for depth_below in range(num_downs - 1, -1, -1):
        outermost, innermost = depth_below == num_downs - 1, depth_below == 0
        if outermost:
            down, sub, up, dn, un = 0, 1, 3, None, None
        elif innermost:
            down, sub, up, dn, un = 1, None, 3, None, 4
        else:
            down, sub, up, dn, un = 1, 3, 5, 2, 6
        convs[f"{name}down"] = f"{ref}{down}"
        convts[f"{name}up"] = f"{ref}{up}"
        if dn is not None:
            norms[f"{name}downnorm"] = f"{ref}{dn}"
        if un is not None:
            norms[f"{name}upnorm"] = f"{ref}{un}"
        if sub is not None:
            name, ref = f"{name}sub.", f"{ref}{sub}.model."
    return convs, convts, norms


def _tower(sd: Mapping, prefix: str, keys: Mapping[str, str],
           norms: Mapping[str, str] = {}) -> dict:
    """Rename one network's conv weights and biases, and its batch norms'
    parameters and buffers.  The reference's tensors are torch's layout
    already (OIHW, and IOHW for the transposed convs), which is the port's:
    keys change, tensors do not."""
    out: dict[str, torch.Tensor] = {}
    for name, ref in keys.items():
        out[f"{name}.weight"] = _tensor(sd[f"{prefix}{ref}.weight"])
        if f"{prefix}{ref}.bias" in sd:
            out[f"{name}.bias"] = _tensor(sd[f"{prefix}{ref}.bias"])
    for name, ref in norms.items():
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{field}"] = _tensor(sd[f"{prefix}{ref}.{field}"])
        key = f"{prefix}{ref}.num_batches_tracked"
        out[f"{name}.num_batches_tracked"] = (
            torch.from_numpy(np.array(sd[key], np.int64)) if key in sd
            else torch.zeros((), dtype=torch.long))
    return out


def _generator_keys(bc) -> tuple[dict[str, str], dict[str, str]]:
    """(convs and transposed convs, norms) of the configured generator:
    the port's layer names -> the reference's."""
    if bc.netG.startswith("unet"):
        convs, convts, norms = _unet_keys(7 if bc.netG == "unet_128" else 8)
        return {**convs, **convts}, norms
    n_blocks = 9 if bc.netG == "resnet_9blocks" else 6
    dropout = not bc.no_dropout
    return (_resnet_generator_keys(n_blocks, dropout),
            _resnet_norm_keys(n_blocks, dropout))


def _discriminator_keys(bc) -> tuple[dict[str, str], dict[str, str]]:
    """(convs, norms) of the configured discriminator."""
    if bc.netD == "pixel":
        return _PIXEL_KEYS, _PIXEL_NORM_KEYS
    n_layers = 3 if bc.netD == "basic" else bc.n_layers_D
    return _nlayer_discriminator_keys(n_layers), _nlayer_norm_keys(n_layers)


# the inject variant's extras keep their names and layouts
_G_EXTRAS = ("fc.weight", "fc.bias") + _SCALARS


def _generator(sd: Mapping, bc) -> dict:
    keys, norms = _generator_keys(bc)
    out = _tower(sd, "netG.", keys, norms if bc.norm == "batch" else {})
    for name in _G_EXTRAS:
        if f"netG.{name}" in sd:
            out[name] = _tensor(sd[f"netG.{name}"])
    # the scalars are 0-d parameters here; a file may hold them as (1,)
    for name in _SCALARS:
        if name in out:
            out[name] = out[name].reshape(())
    return out


def _discriminator(sd: Mapping, bc) -> dict:
    keys, norms = _discriminator_keys(bc)
    return _tower(sd, "netD.", keys, norms if bc.norm == "batch" else {})


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
        out["netG"] = _generator(sd, bc)
    if any(k.startswith("netD.") for k in sd):
        out["netD"] = _discriminator(sd, bc)
    return out


def _host32(t: torch.Tensor) -> torch.Tensor:
    """A tensor of the port's state_dict as the JAX package's exporter
    writes it: a contiguous f32 copy on the host, a 0-d scalar as a
    1-element vector (``np.ascontiguousarray``; torch loads it back into a
    0-d parameter)."""
    return torch.atleast_1d(t.detach().to("cpu", torch.float32)).contiguous().clone()


def _untower(sd: Mapping[str, torch.Tensor], prefix: str,
             keys: Mapping[str, str]) -> dict[str, torch.Tensor]:
    """``_tower`` in reverse for the convs: the port's ``{name}.weight`` /
    ``.bias`` under the reference's ``{prefix}{index}`` names."""
    out: dict[str, torch.Tensor] = {}
    for name, ref in keys.items():
        out[f"{prefix}{ref}.weight"] = _host32(sd[f"{name}.weight"])
        if f"{name}.bias" in sd:
            out[f"{prefix}{ref}.bias"] = _host32(sd[f"{name}.bias"])
    return out


def export_reference_weights(netG_sd: Optional[Mapping[str, torch.Tensor]],
                             netD_sd: Optional[Mapping[str, torch.Tensor]],
                             config) -> dict[str, torch.Tensor]:
    """The port's generator and discriminator state_dicts (either may be
    None) as one reference ``Px2Px_PL`` state_dict (``netG.*``, ``netD.*``
    in the ``nn.Sequential`` layout), f32 on the host: the inverse of
    ``load_reference_weights``, from the same key tables, and the key set of
    ``export_px2px_checkpoint`` in ``nirgan_tpu/train/torch_convert.py``.
    As there, the convs, the transposed convs and the inject variant's
    ``fc`` and scalars are written, no norm: a batch-norm net's
    parameters and running statistics are not exported."""
    bc = config.base_configs
    out: dict[str, torch.Tensor] = {}
    if netG_sd is not None:
        out.update(_untower(netG_sd, "netG.", _generator_keys(bc)[0]))
        for name in _G_EXTRAS:
            if name in netG_sd:
                out[f"netG.{name}"] = _host32(netG_sd[name])
    if netD_sd is not None:
        out.update(_untower(netD_sd, "netD.", _discriminator_keys(bc)[0]))
    return out


def load_reference_ckpt(path: str, config) -> dict[str, torch.Tensor]:
    """Generator state_dict from a reference ``Px2Px_PL`` ``.ckpt``."""
    loaded = load_reference_weights(path, config)
    if "netG" not in loaded:
        raise ValueError(f"{path}: no netG.* weights in the checkpoint")
    return loaded["netG"]


def load_baseline_weights(path_or_sd, model_name: str) -> dict[str, torch.Tensor]:
    """A reference baseline's state_dict (``model/baseline_models.py``:
    ``linear`` / ``mlp.{0,2,4}`` / ``net.{0,2,4}``) as the port's, as
    ``convert_baseline`` maps it: each ``nn.Linear`` (out, in) becomes a 1x1
    conv (out, in, 1, 1)."""
    sd = (load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else path_or_sd)

    def layer(name: str, ref: str, linear: bool) -> dict:
        w = np.asarray(sd[f"{ref}.weight"])
        out = {f"{name}.weight": _tensor(w[:, :, None, None] if linear else w)}
        if f"{ref}.bias" in sd:
            out[f"{name}.bias"] = _tensor(sd[f"{ref}.bias"])
        return out

    if model_name == "Linear_NIR":
        return layer("linear", "linear", True)
    if model_name == "MLP_NIR":
        return {k: v for i in range(3)
                for k, v in layer(f"fc{i}", f"mlp.{2 * i}", True).items()}
    if model_name == "CNN_NIR":
        return {k: v for i in range(3)
                for k, v in layer(f"conv{i}", f"net.{2 * i}", False).items()}
    raise ValueError("Invalid Model Name")
