"""Network factories, counterparts of ``define_G`` and ``define_D`` in
``nirgan_tpu/models/factory.py`` (reference ``model/networks.py:120-208``)
for the ResNet generators and the PatchGAN discriminators."""

from __future__ import annotations

from typing import Optional

import torch

from nirgan_tpu_torch.models.discriminator import NLayerDiscriminator
from nirgan_tpu_torch.models.generator import ResnetGenerator
from nirgan_tpu_torch.ops.initializers import get_initializer

_RESNET_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6}


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str,
             norm: str = "batch", use_dropout: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             compute_dtype=torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> ResnetGenerator:
    """Create a generator: resnet_9blocks | resnet_6blocks.  Weights are
    drawn from ``generator`` (a CPU ``torch.Generator``; seed 0 if none)."""
    if netG not in _RESNET_BLOCKS:
        raise NotImplementedError(
            f"Generator model name [{netG}] is not ported yet")
    g = ResnetGenerator(input_nc, output_nc, ngf, norm_type=norm,
                        use_dropout=use_dropout, n_blocks=_RESNET_BLOCKS[netG],
                        compute_dtype=compute_dtype, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    g.reset_parameters(generator, get_initializer(init_type, init_gain))
    return g


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3,
             norm: str = "batch", init_type: str = "normal",
             init_gain: float = 0.02, compute_dtype=torch.float32,
             device: Optional[torch.device] = None,
             generator: Optional[torch.Generator] = None) -> NLayerDiscriminator:
    """Create a discriminator: basic (the 70x70 PatchGAN, 3 layers) |
    n_layers.  Weights are drawn from ``generator`` (seed 0 if none)."""
    if netD == "basic":
        n_layers = 3
    elif netD == "n_layers":
        n_layers = n_layers_D
    else:
        raise NotImplementedError(
            f"Discriminator model name [{netD}] is not ported yet")
    d = NLayerDiscriminator(input_nc, ndf, n_layers, norm_type=norm,
                            compute_dtype=compute_dtype, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d.reset_parameters(generator, get_initializer(init_type, init_gain))
    return d
