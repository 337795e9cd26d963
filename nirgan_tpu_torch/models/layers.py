"""Building-block modules with torch-parity numerics on NHWC activations,
counterpart of ``nirgan_tpu/models/layers.py``, and the generators'
dropout (flax ``nn.Dropout``).

Weights keep torch's layouts (conv OIHW, conv-transpose IOHW) and the batch
norm torch's names, so the modules' state_dict is the reference format;
activations are NHWC as in the JAX package.  The modules that behave
differently in training (the batch norm, the dropout) follow the module's
``training`` flag, which the task sets: the factories return networks in
eval mode, as the JAX modules apply with ``train=False`` unless asked.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nirgan_tpu_torch.ops.conv import conv2d, conv_transpose2d
from nirgan_tpu_torch.ops.initializers import Init, batchnorm_scale_init
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

    transposed = False

    def reset_parameters(self, init: Init, generator: torch.Generator) -> None:
        init(self.weight, generator, transposed=self.transposed)
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

    transposed = True

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
    (affine-free, no running stats), "batch" (affine, with running
    statistics) or "none".  ``relu=True`` applies the ReLU that follows the
    norm in the generator, and ``residual`` is added to the result, a
    residual block's skip (both fused into the instance-norm kernel on a
    card; the batch norm runs on PyTorch's ops, as the JAX package runs it
    in XLA).

    The batch norm (``features`` channels) has torch's names, ``weight``,
    ``bias``, ``running_mean``, ``running_var`` and
    ``num_batches_tracked``, and flax 0.12's arithmetic
    (``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``): in
    training, f32 statistics over (B, H, W) with the biased var = max(0,
    E[x^2] - E[x]^2), and the running averages move to 0.9 ra + 0.1 batch,
    the biased variance included (torch's ``F.batch_norm`` keeps the
    unbiased one); in eval mode the running averages normalise.  The result
    is computed in f32 and cast back to x's dtype."""

    def __init__(self, norm_type: str = "instance", features: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        if norm_type not in ("instance", "batch", "none"):
            raise NotImplementedError(
                f"normalization layer [{norm_type}] is not found")
        self.norm_type = norm_type
        if norm_type == "batch":
            if features <= 0:
                raise ValueError("a batch norm needs its channel count")
            self.weight = nn.Parameter(torch.ones(features, device=device))
            self.bias = nn.Parameter(torch.zeros(features, device=device))
            self.register_buffer("running_mean",
                                 torch.zeros(features, device=device))
            self.register_buffer("running_var",
                                 torch.ones(features, device=device))
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The batch norm's scale from N(1, 0.02), its shift zero."""
        if self.norm_type == "batch":
            batchnorm_scale_init(self.weight, generator)
            with torch.no_grad():
                self.bias.zero_()

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=(0, 1, 2))
            var = torch.clamp((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean
                                        + (1 - 0.9) * mean.detach())
                self.running_var.copy_(0.9 * self.running_var
                                       + (1 - 0.9) * var.detach())
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_type == "instance":
            return instance_norm(x, relu=relu, residual=residual)
        y = self._batch_norm(x) if self.norm_type == "batch" else x
        y = torch.relu(y) if relu else y
        return y if residual is None else residual + y


def keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Dropout's keep-mask: U[0, 1) < ``keep_prob`` from ``generator``, a
    ``torch.Generator`` on ``device`` (``jax.random.bernoulli``'s rule on
    torch's stream)."""
    if generator is None:
        raise ValueError("dropout in training needs a generator (the task "
                         "hands its train state's one to the network)")
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training, x / (1 - rate) where the keep
    mask is set and 0 elsewhere; the identity in eval mode.  The mask is
    drawn from ``generator`` (on x's device), which the task sets from its
    train state before a training forward."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = keep_mask(tuple(x.shape), keep_prob, self.generator, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every ``Dropout`` under ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def use_bias_for(norm_type: str) -> bool:
    """Reference quirk: conv bias is on only under InstanceNorm
    (``model/networks.py:336-339``)."""
    return norm_type == "instance"
