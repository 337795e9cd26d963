"""Network factories, counterparts of ``define_G``, ``define_G_inject`` and
``define_D`` in ``nirgan_tpu/models/factory.py`` (reference
``model/networks.py:120-208``, ``model/generator_inject.py:145-200``): the
ResNet and U-Net generators, the PatchGAN and PixelGAN discriminators.
Networks come back in eval mode, as the JAX modules apply with
``train=False``; the task switches them to training for a step."""

from __future__ import annotations

from typing import Optional

import torch

from torch import nn

from nirgan_tpu_torch.models.discriminator import NLayerDiscriminator, PixelDiscriminator
from nirgan_tpu_torch.models.generator import ResnetGenerator
from nirgan_tpu_torch.models.unet import UnetGenerator
from nirgan_tpu_torch.ops.initializers import get_initializer

_RESNET_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6}
_UNET_DOWNS = {"unet_128": 7, "unet_256": 8}


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str,
             norm: str = "batch", use_dropout: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             compute_dtype=torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Create a generator: resnet_9blocks | resnet_6blocks | unet_256 |
    unet_128.  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 if none)."""
    kw = dict(norm_type=norm, use_dropout=use_dropout,
              compute_dtype=compute_dtype, device=device)
    if netG in _RESNET_BLOCKS:
        g = ResnetGenerator(input_nc, output_nc, ngf,
                            n_blocks=_RESNET_BLOCKS[netG], **kw)
    elif netG in _UNET_DOWNS:
        g = UnetGenerator(input_nc, output_nc, _UNET_DOWNS[netG], ngf, **kw)
    else:
        raise NotImplementedError(
            f"Generator model name [{netG}] is not recognized")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    g.reset_parameters(generator, get_initializer(init_type, init_gain))
    return g.eval()


def define_G_inject(config, compute_dtype=torch.float32,
                    device: Optional[torch.device] = None,
                    generator: Optional[torch.Generator] = None) -> ResnetGenerator:
    """The SatCLIP-injection generator from a full config tree
    (resnet_9blocks only, as the reference)."""
    bc, sc = config.base_configs, config.satclip
    if bc.netG != "resnet_9blocks":
        raise NotImplementedError(
            f"Generator model name [{bc.netG}] is not recognized. Only "
            "resnet_9blocks for SatCLIP.")
    g = ResnetGenerator(
        bc.input_nc, bc.output_nc, bc.ngf, norm_type=bc.norm,
        use_dropout=not bc.no_dropout, n_blocks=9,
        compute_dtype=compute_dtype, device=device, inject=True,
        inject_style=sc.satclip_inject_style,
        scaling_param=bool(sc.get("scaling_param", True)),
        scaling_param_init=float(sc.get("scaling_param_init", 0.01)),
        post_correction=bool(sc.get("post_correction", False)),
        post_correction_init=float(sc.get("post_correction_init", 1.0)))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    g.reset_parameters(generator, get_initializer(bc.init_type, bc.init_gain))
    return g.eval()


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3,
             norm: str = "batch", init_type: str = "normal",
             init_gain: float = 0.02, compute_dtype=torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Create a discriminator: basic (the 70x70 PatchGAN, 3 layers) |
    n_layers | pixel.  Weights are drawn from ``generator`` (seed 0 if
    none)."""
    kw = dict(norm_type=norm, compute_dtype=compute_dtype, device=device)
    if netD == "basic":
        d = NLayerDiscriminator(input_nc, ndf, 3, **kw)
    elif netD == "n_layers":
        d = NLayerDiscriminator(input_nc, ndf, n_layers_D, **kw)
    elif netD == "pixel":
        d = PixelDiscriminator(input_nc, ndf, **kw)
    else:
        raise NotImplementedError(
            f"Discriminator model name [{netD}] is not recognized")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d.reset_parameters(generator, get_initializer(init_type, init_gain))
    return d.eval()
