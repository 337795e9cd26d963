"""Baseline RGB->NIR regressors, counterpart of
``nirgan_tpu/models/baselines.py`` (reference ``model/baseline_models.py``):
a per-pixel linear map (3 -> 1), a per-pixel MLP (3 -> 64 -> 64 -> 1) and a
three-layer CNN (3 -> 32 -> 64 -> 1, 3x3, padding 1), trained with plain
MSE.

The per-pixel layers are 1x1 convs on NHWC activations, the same maths as
the reference's rows of pixels through ``nn.Linear``, under the JAX
module's names (``linear``; ``fc0``-``fc2``; ``conv0``-``conv2``).  All run
on PyTorch's own convolutions: no TPU kernel stands behind them.  Weights
and biases start from torch's default for ``nn.Linear`` / ``nn.Conv2d``,
U(+-1/sqrt(fan_in)), drawn from an explicit generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nirgan_tpu_torch.models.layers import TorchConv, dtype_of
from nirgan_tpu_torch.ops.initializers import torch_default

__all__ = ["LinearNIR", "MLPNIR", "CNNNIR", "build_baseline"]


class _Baseline(nn.Module):
    # (name, cin, cout, kernel) of each layer, a ReLU between them
    layers: tuple = ()

    def __init__(self, compute_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.compute_dtype = dtype_of(compute_dtype)
        for name, cin, cout, k in self.layers:
            self.add_module(name, TorchConv(cin, cout, k, padding=k // 2,
                                            device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, cin, _, k in self.layers:
            conv = getattr(self, name)
            torch_default(conv.weight, generator, cin * k * k)
            torch_default(conv.bias, generator, cin * k * k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, H, W, 1) in ``compute_dtype``."""
        h = x.to(self.compute_dtype)
        for i, (name, *_) in enumerate(self.layers):
            h = getattr(self, name)(h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


class LinearNIR(_Baseline):
    layers = (("linear", 3, 1, 1),)


class MLPNIR(_Baseline):
    layers = (("fc0", 3, 64, 1), ("fc1", 64, 64, 1), ("fc2", 64, 1, 1))


class CNNNIR(_Baseline):
    layers = (("conv0", 3, 32, 3), ("conv1", 32, 64, 3), ("conv2", 64, 1, 3))


_MODELS = {"Linear_NIR": LinearNIR, "MLP_NIR": MLPNIR, "CNN_NIR": CNNNIR}


def build_baseline(model_name: str, compute_dtype=torch.float32,
                   device: Optional[torch.device] = None,
                   generator: Optional[torch.Generator] = None) -> _Baseline:
    """String dispatch of the reference CLI (``train.py:51-58``); weights
    from ``generator`` (a CPU ``torch.Generator``; seed 0 if none)."""
    if model_name not in _MODELS:
        raise ValueError("Invalid Model Name")
    model = _MODELS[model_name](compute_dtype, device)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model
