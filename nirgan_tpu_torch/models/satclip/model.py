"""The full SatCLIP model, counterpart of
``nirgan_tpu/models/satclip/model.py`` (reference
``model/satclip/model.py``): a CLIP-style dual encoder over (satellite
image, location) with a ModifiedResNet, a VisionTransformer or a timm
``moco_*`` vision tower and a trainable location network over host-made
positional features, joined by a temperature-scaled cosine-similarity logit
matrix and a symmetric cross-entropy loss (``model/satclip/loss.py:37-47``).

NHWC activations; the parameters carry the reference's (OpenAI CLIP's)
state_dict names: ``visual.conv1``, ``visual.layer1.0.downsample.0``,
``visual.attnpool.q_proj``, ``visual.transformer.resblocks.0.attn.in_proj_weight``,
``location.nnet.layers.0``, ``logit_scale``.  The location network sits at
``location.nnet``, as in the reference's Lightning checkpoints.  What
follows the JAX package rather than torch's defaults:

  * the layer norms are flax's (eps 1e-6, computed in f32);
  * the batch norms are flax's (``layers.Norm("batch")``: momentum 0.9,
    eps 1e-5, f32 statistics, the running variance moves by the biased
    batch variance);
  * the attention pool's softmax runs in f32 and only its mean token
    queries; ``logit_scale`` starts at log(1 / 0.07) and is not clamped;
  * SirenNet drops out (p 0.5) after each hidden layer, before sin(w0 x);
  * the MLP's hidden layers are distinct (the reference repeats one module,
    ``location_encoder.py:58``, an accidental weight sharing);
  * initialisation draws flax's distributions from a ``torch.Generator``.
Modules follow ``training`` (the task sets it), as the JAX modules follow
``train``; a module with dropout takes its generator through
``layers.set_dropout_generator``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nirgan_tpu_torch.models.layers import Dropout, Norm, TorchConv
from nirgan_tpu_torch.models.satclip.timm_towers import (
    PRETRAINED_TOWERS,
    AvgPool,
    LayerNorm32,
    attention,
    avg_pool,
    build_pretrained_tower,
    init_flax,
    lecun_,
    merge_heads,
    normal_,
    split_heads,
)

__all__ = ["SatCLIP", "satclip_loss", "ModifiedResNet", "VisionTransformer",
           "AttentionPool2d", "SirenNet", "LocMLP", "FCNet", "get_neural_network",
           "quick_gelu", "CLIPLayerNorm"]

CLIPLayerNorm = LayerNorm32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


# --------------------------------------------------------------------------
# ModifiedResNet vision tower
# --------------------------------------------------------------------------

class Bottleneck(nn.Module):
    """CLIP bottleneck: the stride is an avg-pool after conv2; the
    downsample branch is avg-pool (``-1``), 1x1 conv (``0``), batch norm
    (``1``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        out = planes * self.expansion
        self.stride = int(stride)
        self.conv1 = TorchConv(inplanes, planes, 1, 1, 0, False, device)
        self.bn1 = Norm("batch", planes, device)
        self.conv2 = TorchConv(planes, planes, 3, 1, 1, False, device)
        self.bn2 = Norm("batch", planes, device)
        self.conv3 = TorchConv(planes, out, 1, 1, 0, False, device)
        self.bn3 = Norm("batch", out, device)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", AvgPool(stride)),
                ("0", TorchConv(inplanes, out, 1, 1, 0, False, device)),
                ("1", Norm("batch", out, device))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), relu=True)
        h = self.bn2(self.conv2(h), relu=True)
        if self.stride > 1:
            h = avg_pool(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pool (reference ``model.py:65-98``): the mean token,
    alone, queries itself and all (h w) spatial tokens, each with its row
    of ``positional_embedding``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim, device=device))
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.c_proj = nn.Linear(embed_dim, output_dim, device=device)
        normal_(self.positional_embedding, embed_dim ** -0.5, generator)
        for lin in (self.k_proj, self.q_proj, self.v_proj, self.c_proj):
            normal_(lin.weight, embed_dim ** -0.5, generator)
            with torch.no_grad():
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, H, W, C)
        b, h, w, c = x.shape
        tok = x.reshape(b, h * w, c)
        tok = torch.cat([tok.mean(dim=1, keepdim=True), tok], dim=1)
        tok = tok + self.positional_embedding.to(tok.dtype)
        q = split_heads(self.q_proj(tok[:, :1]), self.num_heads)
        k = split_heads(self.k_proj(tok), self.num_heads)
        v = split_heads(self.v_proj(tok), self.num_heads)
        return self.c_proj(merge_heads(attention(q, k, v)))[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP's ResNet (reference ``model.py:101-166``): a 3-conv stem and an
    avg-pool, anti-aliased strides, the attention pool head."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 in_channels: int = 3, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        w = width
        self.conv1 = TorchConv(in_channels, w // 2, 3, 2, 1, False, device)
        self.bn1 = Norm("batch", w // 2, device)
        self.conv2 = TorchConv(w // 2, w // 2, 3, 1, 1, False, device)
        self.bn2 = Norm("batch", w // 2, device)
        self.conv3 = TorchConv(w // 2, w, 3, 1, 1, False, device)
        self.bn3 = Norm("batch", w, device)
        inplanes = w
        for stage, (n_blocks, mult, stride) in enumerate(
                zip(layers, (1, 2, 4, 8), (1, 2, 2, 2))):
            blocks = []
            for i in range(n_blocks):
                blocks.append(Bottleneck(inplanes, w * mult,
                                         stride if i == 0 else 1, device))
                inplanes = w * mult * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        init_flax(self, generator)
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads,
                                        output_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), relu=True)
        h = self.bn2(self.conv2(h), relu=True)
        h = self.bn3(self.conv3(h), relu=True)
        h = avg_pool(h, 2)
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
        return self.attnpool(h)


# --------------------------------------------------------------------------
# VisionTransformer tower
# --------------------------------------------------------------------------

class MultiheadAttention(nn.Module):
    """Self-attention under torch ``nn.MultiheadAttention``'s names
    (``in_proj_weight`` (3d, d), ``in_proj_bias``, ``out_proj``), with flax
    ``MultiHeadDotProductAttention``'s arithmetic: its separate q, k, v
    kernels are the three row blocks of ``in_proj_weight``."""

    def __init__(self, d_model: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun-normal on each of q, k and v (fan_in d), zero
        biases."""
        d = self.in_proj_weight.shape[1]
        for i in range(3):
            block = torch.empty(d, d)
            lecun_(block, generator)
            with torch.no_grad():
                self.in_proj_weight[i * d:(i + 1) * d].copy_(block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight.to(x.dtype),
                           self.in_proj_bias.to(x.dtype)).chunk(3, dim=-1)
        o = attention(split_heads(q, self.n_head), split_heads(k, self.n_head),
                      split_heads(v, self.n_head))
        return self.out_proj(merge_heads(o))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, device=None):
        super().__init__()
        self.attn = MultiheadAttention(d_model, n_head, device)
        self.ln_1 = CLIPLayerNorm(d_model, device)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4, device=device)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model, device=device))]))
        self.ln_2 = CLIPLayerNorm(d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.width, self.layers = width, layers
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads, device)
                                         for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


class VisionTransformer(nn.Module):
    """CLIP ViT (reference ``model.py:213-247``): patch conv without bias,
    class token, positional embedding, ``ln_pre``, the blocks, ``ln_post``
    on the class token, ``proj``."""

    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, in_channels: int, output_dim: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        scale = width ** -0.5
        n_tokens = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = TorchConv(in_channels, width, patch_size, patch_size, 0,
                               False, device)
        self.class_embedding = nn.Parameter(torch.zeros(width, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(n_tokens, width,
                                                             device=device))
        self.ln_pre = CLIPLayerNorm(width, device)
        self.transformer = Transformer(width, layers, heads, device)
        self.ln_post = CLIPLayerNorm(width, device)
        self.proj = nn.Parameter(torch.zeros(width, output_dim, device=device))
        init_flax(self, generator)
        for block in self.transformer.resblocks:
            block.attn.reset_parameters(generator)
        normal_(self.class_embedding, scale, generator)
        normal_(self.positional_embedding, scale, generator)
        normal_(self.proj, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        b, width = h.shape[0], h.shape[-1]
        h = h.reshape(b, -1, width)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, width)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.transformer(self.ln_pre(h))
        return self.ln_post(h[:, 0]) @ self.proj.to(h.dtype)


# --------------------------------------------------------------------------
# trainable location networks (reference location_encoder.py:13-151)
# --------------------------------------------------------------------------

class SirenLayer(nn.Module):
    """One reference ``Siren`` layer: ``weight`` (out, in) and ``bias``,
    both U(-s, s) with s = 1 / dim_in for the first layer, else
    sqrt(6 / dim_in) / w0; then, in a hidden layer, dropout and
    sin(w0 x)."""

    def __init__(self, dim_in: int, dim_out: int, w0: float, is_first: bool,
                 hidden: bool, dropout: bool, generator: Optional[torch.Generator],
                 device=None):
        super().__init__()
        self.w0, self.hidden = float(w0), hidden
        s = (1.0 / dim_in) if is_first else (math.sqrt(6.0 / dim_in) / w0)
        draw = lambda *shape: torch.empty(shape).uniform_(-s, s, generator=generator)
        self.weight = nn.Parameter(draw(dim_out, dim_in).to(device))
        self.bias = nn.Parameter(draw(dim_out).to(device))
        self.dropout = Dropout(0.5) if hidden and dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x, self.weight, self.bias)
        if not self.hidden:
            return x
        if self.dropout is not None:
            x = self.dropout(x)
        return torch.sin(self.w0 * x)


class SirenNet(nn.Module):
    def __init__(self, dim_in: int, dim_hidden: int = 256, dim_out: int = 256,
                 num_layers: int = 2, w0: float = 1.0, w0_initial: float = 30.0,
                 dropout: bool = True, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * num_layers
        self.layers = nn.ModuleList([
            SirenLayer(dims[i], dims[i + 1], w0_initial if i == 0 else w0, i == 0,
                       True, dropout, generator, device)
            for i in range(num_layers)])
        self.last_layer = SirenLayer(dim_hidden, dim_out, w0, False, False, False,
                                     generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.last_layer(x)


class LocMLP(nn.Module):
    """The reference MLP (``features``: Linear, ReLU, then ``num_layers``
    x (Linear, ReLU), then Linear), its hidden layers distinct."""

    def __init__(self, dim_in: int, dim_hidden: int = 256, dim_out: int = 256,
                 num_layers: int = 2, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        mods = [nn.Linear(dim_in, dim_hidden, device=device), nn.ReLU()]
        for _ in range(num_layers):
            mods += [nn.Linear(dim_hidden, dim_hidden, device=device), nn.ReLU()]
        mods.append(nn.Linear(dim_hidden, dim_out, device=device))
        self.features = nn.Sequential(*mods)
        init_flax(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


class ResLayer(nn.Module):
    """FCNet's residual layer: x + relu(w2(dropout(relu(w1(x)))))."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.w1 = nn.Linear(dim, dim, device=device)
        self.dropout1 = Dropout(0.5)
        self.w2 = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout1(torch.relu(self.w1(x)))
        return x + torch.relu(self.w2(y))


class FCNet(nn.Module):
    """``feats``: Linear, ReLU and four ``ResLayer``s; ``class_emb`` without
    bias."""

    def __init__(self, dim_in: int, dim_hidden: int = 256, dim_out: int = 256,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.feats = nn.Sequential(nn.Linear(dim_in, dim_hidden, device=device),
                                   nn.ReLU(),
                                   *[ResLayer(dim_hidden, device) for _ in range(4)])
        self.class_emb = nn.Linear(dim_hidden, dim_out, bias=False, device=device)
        init_flax(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.class_emb(self.feats(x))


def get_neural_network(name: str, dim_in: int, num_classes: int = 256,
                       dim_hidden: int = 256, num_layers: int = 2,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> nn.Module:
    """Dispatch (reference ``location_encoder.py:241-265``); 'linear' is
    one dense layer."""
    if name == "linear":
        lin = nn.Linear(dim_in, num_classes, device=device)
        init_flax(lin, generator)
        return lin
    if name == "mlp":
        return LocMLP(dim_in, dim_hidden, num_classes, num_layers, generator, device)
    if name == "siren":
        return SirenNet(dim_in, dim_hidden, num_classes, num_layers,
                        generator=generator, device=device)
    if name == "fcnet":
        return FCNet(dim_in, dim_hidden, num_classes, generator, device)
    raise ValueError(f"{name} not a known neural networks.")


class LocationTower(nn.Module):
    """The reference ``LocationEncoder``'s trainable part: ``nnet`` over the
    positional features (the encoding itself runs on the host)."""

    def __init__(self, nnet: nn.Module):
        super().__init__()
        self.nnet = nnet

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.nnet(features)


# --------------------------------------------------------------------------
# SatCLIP
# --------------------------------------------------------------------------

class SatCLIP(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 vision_layers: Union[Tuple[int, int, int, int], int, str] = (3, 4, 6, 3),
                 vision_width: int = 64, vision_patch_size: int = 32,
                 image_resolution: int = 256, in_channels: int = 4,
                 pe_type: str = "siren", capacity: int = 256,
                 num_hidden_layers: int = 2, location_dim: int = 100,
                 generator: Optional[torch.Generator] = None, device=None):
        """``location_dim``: the width of the positional features (the
        encoding's ``embedding_dim``).  Weights are drawn from
        ``generator``, the tower first."""
        super().__init__()
        if isinstance(vision_layers, (tuple, list)):
            self.visual = ModifiedResNet(
                vision_layers, embed_dim, max(1, vision_width * 32 // 64),
                image_resolution, vision_width, in_channels, generator, device)
        elif isinstance(vision_layers, str) and vision_layers in PRETRAINED_TOWERS:
            # reference model.py:287-312: the timm tower for the SSL4EO MoCo
            # weights (13-band Sentinel-2), frozen by the task but for its head
            self.visual = build_pretrained_tower(vision_layers, embed_dim,
                                                 image_resolution, generator, device)
        else:
            self.visual = VisionTransformer(
                image_resolution, vision_patch_size, vision_width, int(vision_layers),
                max(1, vision_width // 64), in_channels, embed_dim, generator, device)
        self.location = LocationTower(get_neural_network(
            pe_type, location_dim, embed_dim, capacity, num_hidden_layers,
            generator, device))
        self.logit_scale = nn.Parameter(torch.full((), math.log(1.0 / 0.07),
                                                   device=device))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_location(self, loc_features: torch.Tensor) -> torch.Tensor:
        return self.location(loc_features)

    def forward(self, image: torch.Tensor, loc_features: torch.Tensor):
        """image (B, H, W, C) NHWC; ``loc_features`` the positional encoding
        of (lon, lat), made on the host.  Returns (logits_per_image,
        logits_per_location)."""
        img = self.encode_image(image).float()
        loc = self.encode_location(loc_features.to(image.dtype)).float()
        img = img / img.norm(dim=1, keepdim=True)
        loc = loc / loc.norm(dim=1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ loc.t()
        return logits_per_image, logits_per_image.t()


def satclip_loss(logits_per_image: torch.Tensor,
                 logits_per_coord: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE (reference ``loss.py:37-47``): the mean of the two
    cross-entropies against the diagonal."""
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    return (F.cross_entropy(logits_per_image.float(), labels)
            + F.cross_entropy(logits_per_coord.float(), labels)) / 2.0
