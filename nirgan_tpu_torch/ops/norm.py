"""Normalisation (NHWC), counterpart of ``nirgan_tpu/ops/norm.py``.

Affine-free, stat-free instance norm everywhere (reference
``model/networks.py:30``).  A CUDA tensor runs kernel B
(``ops/instance_norm.py``), a CPU tensor its plain version, the JAX formula.
"""

import torch

from nirgan_tpu_torch.ops import _lib
from nirgan_tpu_torch.ops.instance_norm import (
    NAME,
    instance_norm_cuda,
    instance_norm_plain,
)


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """Per-sample, per-channel spatial normalisation (torch defaults: eps
    1e-5, biased variance) with f32 statistics, normalised in x's dtype;
    ``relu=True`` applies ReLU to the result (exact, fused in the kernel)."""
    if _lib.route(x, NAME):
        return instance_norm_cuda(x, eps, relu)
    return instance_norm_plain(x, eps, relu)
