"""PatchGAN discriminators, counterparts of ``NLayerDiscriminator`` and
``PixelDiscriminator`` in ``nirgan_tpu/models/discriminator.py`` (reference
``model/networks.py:539-616``).

The 70x70 PatchGAN: 4x4 convs, stride 2 for the first ``n_layers`` and
stride 1 for the last two, LeakyReLU 0.2, on NHWC activations.  The normed
middle convs follow the InstanceNorm bias rule and the first and last
always carry a bias.  The PixelGAN: three 1x1 convs (PyTorch's own), one
norm.  Every instance norm runs through kernels B and B4 on a card, a batch
norm on PyTorch's ops.  The JAX module's blocked stem is a TPU layout
variant of the same function and is not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nirgan_tpu_torch.models.layers import Norm, TorchConv, dtype_of, use_bias_for
from nirgan_tpu_torch.ops.initializers import Init


def _reset(net: nn.Module, generator: torch.Generator, init: Init) -> None:
    """Draw every conv weight from ``init`` (biases zero) and every batch
    norm's scale from N(1, 0.02), in module order."""
    for m in net.modules():
        if isinstance(m, TorchConv):
            m.reset_parameters(init, generator)
        elif isinstance(m, Norm):
            m.reset_parameters(generator)


class NLayerDiscriminator(nn.Module):
    """Parameter names follow the JAX module: ``conv0`` ... ``conv{n+1}``;
    the norms are ``norm1`` ... ``norm{n}``.  Params are f32;
    ``compute_dtype`` is the activation dtype and the logits' dtype."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "instance", compute_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.compute_dtype = dtype_of(compute_dtype)
        self.n_layers = n_layers
        bias = use_bias_for(norm_type)
        self.conv0 = TorchConv(input_nc, ndf, 4, stride=2, padding=1,
                               use_bias=True, device=device)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", TorchConv(
                cin, cout, 4, stride=stride, padding=1, use_bias=bias,
                device=device))
            self.add_module(f"norm{n}", Norm(norm_type, cout, device))
            cin = cout
        self.add_module(f"conv{n_layers + 1}", TorchConv(
            cin, 1, 4, stride=1, padding=1, use_bias=True, device=device))

    def reset_parameters(self, generator: torch.Generator, init: Init) -> None:
        _reset(self, generator, init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC -> logits (B, H', W', 1) in
        ``compute_dtype``."""
        h = F.leaky_relu(self.conv0(x.to(self.compute_dtype)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(h))
            h = F.leaky_relu(h, 0.2)
        return getattr(self, f"conv{self.n_layers + 1}")(h)


class PixelDiscriminator(nn.Module):
    """1x1 PixelGAN (reference ``model/networks.py:587-616``): ``conv0``
    (ndf, bias), LeakyReLU 0.2, ``conv1`` (2 ndf, the InstanceNorm bias
    rule), ``norm1``, LeakyReLU 0.2, ``conv2`` (1 logit, the same rule), as
    the JAX module names them."""

    def __init__(self, input_nc: int, ndf: int = 64,
                 norm_type: str = "instance", compute_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.compute_dtype = dtype_of(compute_dtype)
        bias = use_bias_for(norm_type)
        self.conv0 = TorchConv(input_nc, ndf, 1, use_bias=True, device=device)
        self.conv1 = TorchConv(ndf, ndf * 2, 1, use_bias=bias, device=device)
        self.norm1 = Norm(norm_type, ndf * 2, device)
        self.conv2 = TorchConv(ndf * 2, 1, 1, use_bias=bias, device=device)

    def reset_parameters(self, generator: torch.Generator, init: Init) -> None:
        _reset(self, generator, init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC -> logits (B, H, W, 1) in
        ``compute_dtype``."""
        h = F.leaky_relu(self.conv0(x.to(self.compute_dtype)), 0.2)
        h = F.leaky_relu(self.norm1(self.conv1(h)), 0.2)
        return self.conv2(h)
