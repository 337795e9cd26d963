"""timm-compatible vision towers for SatCLIP's ``moco_*`` options,
counterpart of ``nirgan_tpu/models/satclip/timm_towers.py`` (reference
``model/satclip/model.py:287-312``): timm's ``resnet18`` / ``resnet50``
(the torchvision layout) and ``vit_small_patch16_224`` with ``in_chans=13``
for torchgeo's SSL4EO Sentinel-2 MoCo weights, frozen but for the head.

The parameters carry timm's own names (``conv1``, ``layer1.0.downsample.0``,
``patch_embed.proj``, ``blocks.0.attn.qkv``, ``fc``, ``head``, ...), so a
timm or torchgeo state_dict loads by name.  Activations are NHWC; the batch
norms are ``layers.Norm("batch")`` (flax's rule, statistics in f32), the
layer norms flax's (eps 1e-6, computed in f32).  Freezing is the pretrain
task's business (``tasks/satclip_pretrain.py``).  The shared pieces of the
CLIP towers (``LayerNorm32``, ``attention``, the NHWC pools and the flax
initialisation) live here too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nirgan_tpu_torch.models.layers import Norm, TorchConv
from nirgan_tpu_torch.ops.initializers import lecun_normal

__all__ = ["TimmResNet", "TimmViT", "build_pretrained_tower",
           "PRETRAINED_TOWERS", "resample_pos_embed"]

lecun_ = lecun_normal()  # flax's default kernel init, in place


def init_flax(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults on every conv and dense layer directly under
    ``module``'s tree: the kernel lecun-normal, the bias zero (layer norms
    and batch norms keep their ones and zeros)."""
    for m in module.modules():
        if isinstance(m, (TorchConv, nn.Linear)):
            lecun_(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))


class LayerNorm32(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-6)`` computed in f32 and cast back (the
    CLIP towers' fp16 guard; timm's ViT norms have the same eps)."""

    def __init__(self, features: int, device=None):
        super().__init__(features, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, heads, Nq, hd) queries over (B, heads, N, hd) keys and values:
    softmax(q k^T / sqrt(hd)) v, the softmax in f32."""
    attn = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return attn.float().softmax(dim=-1).to(v.dtype) @ v


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax ``avg_pool(x, (k, k), (k, k))`` on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


class AvgPool(nn.Module):
    """``avg_pool`` as a module (the CLIP bottleneck's downsample branch
    starts with one); stride 1 is the identity."""

    def __init__(self, k: int):
        super().__init__()
        self.k = int(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(x, self.k) if self.k > 1 else x


def _downsample(cin: int, cout: int, stride: int, device) -> nn.Sequential:
    """torchvision's ``downsample``: a strided 1x1 conv (``0``) and its
    batch norm (``1``)."""
    return nn.Sequential(TorchConv(cin, cout, 1, stride, 0, False, device),
                         Norm("batch", cout, device))


class BasicBlock(nn.Module):
    """timm / torchvision ResNet BasicBlock (3x3 + 3x3, expansion 1)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = TorchConv(cin, planes, 3, stride, 1, False, device)
        self.bn1 = Norm("batch", planes, device)
        self.conv2 = TorchConv(planes, planes, 3, 1, 1, False, device)
        self.bn2 = Norm("batch", planes, device)
        self.downsample = (_downsample(cin, planes, stride, device)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), relu=True)
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class TimmBottleneck(nn.Module):
    """timm / torchvision ResNet Bottleneck (1x1, 3x3 with the stride,
    1x1; expansion 4).  Not the CLIP bottleneck of ``model.py``, which
    strides by an avg-pool."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        out = planes * 4
        self.conv1 = TorchConv(cin, planes, 1, 1, 0, False, device)
        self.bn1 = Norm("batch", planes, device)
        self.conv2 = TorchConv(planes, planes, 3, stride, 1, False, device)
        self.bn2 = Norm("batch", planes, device)
        self.conv3 = TorchConv(planes, out, 1, 1, 0, False, device)
        self.bn3 = Norm("batch", out, device)
        self.downsample = (_downsample(cin, out, stride, device)
                           if stride != 1 or cin != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), relu=True)
        h = self.bn2(self.conv2(h), relu=True)
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class TimmResNet(nn.Module):
    """timm ``resnet18`` (BasicBlock, [2, 2, 2, 2]) / ``resnet50``
    (Bottleneck, [3, 4, 6, 3]) with a ``num_classes`` head: 7x7/s2 stem,
    3x3/s2 max-pool with pad 1, four stages, global average pool, ``fc``."""

    def __init__(self, layers: Sequence[int], block: str = "basic",
                 num_classes: int = 256, in_chans: int = 13,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        blk = BasicBlock if block == "basic" else TimmBottleneck
        self.conv1 = TorchConv(in_chans, 64, 7, 2, 3, False, device)
        self.bn1 = Norm("batch", 64, device)
        cin = 64
        for stage, (n, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(blk(cin, planes, stride, device))
                cin = planes * blk.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes, device=device)
        init_flax(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), relu=True)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
        return self.fc(h.mean(dim=(1, 2)))


class _PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, width: int, patch: int, device=None):
        super().__init__()
        self.proj = TorchConv(in_chans, width, patch, patch, 0, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)                                   # (B, gh, gw, width)
        return h.reshape(h.shape[0], -1, h.shape[-1])


class _Attention(nn.Module):
    """timm's ``Attention``: one fused ``qkv`` (its output ordered (3,
    heads, hd)), then ``proj``."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return self.proj(merge_heads(attention(q, k, v)))


class _Mlp(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim, device=device)
        self.fc2 = nn.Linear(4 * dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # the exact (erf) GELU


class ViTBlock(nn.Module):
    """Pre-norm transformer block of timm's ViT: LN, attention, residual;
    LN, MLP (4x, exact GELU), residual."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, device)
        self.attn = _Attention(dim, num_heads, device)
        self.norm2 = LayerNorm32(dim, device)
        self.mlp = _Mlp(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TimmViT(nn.Module):
    """timm ``vit_small_patch16_224`` at ``image_resolution``: patch 16,
    width 384, 12 blocks, 6 heads, a class token, a learned absolute
    position embedding of (side / 16)^2 + 1 rows, class-token pooling,
    ``head``."""

    def __init__(self, patch_size: int = 16, width: int = 384, depth: int = 12,
                 num_heads: int = 6, num_classes: int = 256,
                 image_resolution: int = 224, in_chans: int = 13,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        n_patches = (image_resolution // patch_size) ** 2
        self.patch_embed = _PatchEmbed(in_chans, width, patch_size, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, width,
                                                  device=device))
        self.blocks = nn.Sequential(*[ViTBlock(width, num_heads, device)
                                      for _ in range(depth)])
        self.norm = LayerNorm32(width, device)
        self.head = nn.Linear(width, num_classes, device=device)
        init_flax(self, generator)
        normal_(self.cls_token, 1e-6, generator)
        normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x)
        cls = self.cls_token.to(h.dtype).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(h.dtype)
        h = self.blocks(h)
        return self.head(self.norm(h[:, 0]))


#: reference option name -> (constructor kwargs, head parameter name)
PRETRAINED_TOWERS = {
    "moco_resnet18": (dict(layers=(2, 2, 2, 2), block="basic"), "fc"),
    "moco_resnet50": (dict(layers=(3, 4, 6, 3), block="bottleneck"), "fc"),
    "moco_vit16": (dict(), "head"),
}


def build_pretrained_tower(name: str, embed_dim: int, image_resolution: int = 224,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> nn.Module:
    """Reference ``model.py:287-312``: the SSL4EO weights dictate 13 input
    channels; only the new head (``num_classes``) follows ``embed_dim``."""
    kwargs, _ = PRETRAINED_TOWERS[name]
    if name == "moco_vit16":
        return TimmViT(num_classes=embed_dim, image_resolution=image_resolution,
                       generator=generator, device=device)
    return TimmResNet(num_classes=embed_dim, generator=generator, device=device,
                      **kwargs)


def triangle_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of ``jax.image.resize(..., "bilinear")``
    along one axis: the triangle kernel at half-pixel sample positions,
    each row normalised to sum 1.  Shrinking, it antialiases: the kernel is
    widened by in / out (``F.interpolate`` does not), so every input pixel
    under the wider footprint contributes.  Growing, it is torch's
    ``align_corners=False`` bilinear, clamped at the edges."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resample_pos_embed(pos_embed: np.ndarray, num_patches: int) -> np.ndarray:
    """A ViT ``pos_embed`` (1, 1 + old^2, C) with its grid resampled to
    ``num_patches`` = new^2 rows, as the JAX package's ``convert_timm_vit``
    resamples it (``jax.image.resize`` bilinear); the class row stays."""
    pe = np.asarray(pos_embed)
    cls, grid = pe[:, :1], pe[:, 1:]
    old = int(round(grid.shape[1] ** 0.5))
    new = int(round(num_patches ** 0.5))
    if new == old:
        return pe
    m = triangle_matrix(old, new)
    g = grid.reshape(old, old, -1).astype(np.float64)
    g = np.einsum("ah,hwc->awc", m, g)
    g = np.einsum("bw,awc->abc", m, g)
    return np.concatenate([cls, g.reshape(1, new * new, -1).astype(pe.dtype)],
                          axis=1)
