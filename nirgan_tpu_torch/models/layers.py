"""Building-block modules with torch-parity numerics on NHWC activations,
counterpart of ``nirgan_tpu/models/layers.py``.

Weights keep torch's layouts (conv OIHW, conv-transpose IOHW), so the
modules' state_dict is the reference format; activations are NHWC as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nirgan_tpu_torch.ops.conv import conv2d, conv_transpose2d
from nirgan_tpu_torch.ops.initializers import Init
from nirgan_tpu_torch.ops.instance_norm import instance_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return DTYPES[name] if isinstance(name, str) else name


class _Conv(nn.Module):
    def __init__(self, weight_shape: tuple, features: int, stride: int,
                 padding: int, use_bias: bool, device: Optional[torch.device]):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(weight_shape, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def reset_parameters(self, init: Init, generator: torch.Generator) -> None:
        init(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class TorchConv(_Conv):
    """torch ``nn.Conv2d`` (explicit int padding) on NHWC input."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 device: Optional[torch.device] = None):
        super().__init__((features, cin, kernel_size, kernel_size), features,
                         stride, padding, use_bias, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class TorchConvTranspose(_Conv):
    """torch ``nn.ConvTranspose2d`` (weight (Cin, Cout, kh, kw)) on NHWC
    input; the reference's k3 s2 p1 op1 is an exact 2x upsample."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = True, device: Optional[torch.device] = None):
        super().__init__((cin, features, kernel_size, kernel_size), features,
                         stride, padding, use_bias, device)
        self.output_padding = output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(x, self.weight, self.bias, self.stride,
                                self.padding, self.output_padding)


class Norm(nn.Module):
    """Norm-layer dispatch of the reference ``get_norm_layer``: "instance"
    (affine-free, no running stats) or "none".  "batch" is not ported yet.
    ``relu=True`` applies the ReLU that follows the norm in the generator,
    and ``residual`` is added to the result, a residual block's skip (both
    fused into the instance-norm kernel on a card)."""

    def __init__(self, norm_type: str = "instance"):
        super().__init__()
        if norm_type not in ("instance", "none"):
            raise NotImplementedError(
                f"normalization layer [{norm_type}] is not ported yet")
        self.norm_type = norm_type

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_type == "instance":
            return instance_norm(x, relu=relu, residual=residual)
        y = torch.relu(x) if relu else x
        return y if residual is None else residual + y


def use_bias_for(norm_type: str) -> bool:
    """Reference quirk: conv bias is on only under InstanceNorm
    (``model/networks.py:336-339``)."""
    return norm_type == "instance"
