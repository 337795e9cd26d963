"""Plain PyTorch pix2pix: the ResNet generator (``resnet_{n}blocks``: c7s1,
two stride-2 downsamplings, n residual blocks with reflect padding, two
transposed upsamplings, c7s1 and tanh), the 70x70 PatchGAN (``basic``), the
SatCLIP inject route's location plane, and the fused GAN step (D on the
detached fake and the real pair, then G through the updated D; lsgan +
lambda_L1 * L1; Adam), after the upstream NIR-GAN ``model/networks.py`` and
``model/pix2pix.py``.  NCHW, affine-free instance norm with eps 1e-5 and
conv biases (the InstanceNorm bias rule), as published.

Departures from upstream, each the program's too: the input is
reflect-padded by ``Data.padding_amount`` before G and the result cropped
back; the location plane is resized to (W, H) (the reference's swapped
size, equal on square maps).

``Arith`` is the arithmetic of every convolution: ``PLAIN`` computes in
float32; ``FP8`` rounds each convolution's input, weight and output, and
their gradients, and G's output, to float8 e4m3 with one scale a tensor:
the control, what a program one precision below the configuration's
bfloat16 reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

IN_EPS = 1e-5


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_e4m3(v: torch.Tensor) -> torch.Tensor:
    """v rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448."""
    s = v.abs().amax().clamp(min=1e-30) / 448.0
    return (v / s).to(torch.float8_e4m3fn).to(v.dtype) * s


class _E4M3(torch.autograd.Function):
    """Rounds the tensor forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _round_e4m3(g)


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _E4M3.apply(x)


@dataclass(frozen=True)
class Arith:
    """``operand`` is applied to every convolution's input, weight and
    output (and so, backward, to their gradients), ``output`` to G's
    output."""

    operand: object = _identity
    output: object = _identity


PLAIN = Arith()
FP8 = Arith(to_e4m3, to_e4m3)


def n_blocks(cfg: dict) -> int:
    net = cfg["base_configs"]["netG"]
    if not net.startswith("resnet_") or not net.endswith("blocks"):
        raise ValueError(f"the reference runs resnet generators, not {net}")
    return int(net[len("resnet_"):-len("blocks")])


def inject(cfg: dict) -> bool:
    sc = cfg.get("satclip") or {}
    return bool(sc.get("use_satclip")) and sc.get("satclip_style") == "inject"


def generator_shapes(cfg: dict) -> dict:
    """G's parameters, name -> shape, under the program's state_dict names
    (convs (Cout, Cin, k, k), transposed convs (Cin, Cout, k, k))."""
    bc = cfg["base_configs"]
    g, i, o = bc["ngf"], bc["input_nc"], bc["output_nc"]
    s = {}

    def conv(name, cin, cout, k, transposed=False):
        s[f"{name}.weight"] = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        s[f"{name}.bias"] = (cout,)

    conv("c0", i, g, 7)
    conv("d0", g, 2 * g, 3)
    conv("d1", 2 * g, 4 * g, 3)
    for b in range(n_blocks(cfg)):
        conv(f"r{b}.conv1", 4 * g, 4 * g, 3)
        conv(f"r{b}.conv2", 4 * g, 4 * g, 3)
    conv("u0", 4 * g, 2 * g, 3, transposed=True)
    conv("u1", 2 * g, g, 3, transposed=True)
    conv("c1", g, o, 7)
    if inject(cfg):
        s["fc.weight"] = (128 * 128, 256)
        s["fc.bias"] = (128 * 128,)
        if cfg["satclip"].get("scaling_param", True):
            s["scale_param"] = ()
    return s


def discriminator_shapes(cfg: dict) -> dict:
    bc = cfg["base_configs"]
    if bc["netD"] != "basic":
        raise ValueError(f"the reference runs the basic PatchGAN, not {bc['netD']}")
    d, cin = bc["ndf"], bc["input_nc"] + bc["output_nc"]
    s = {"conv0.weight": (d, cin, 4, 4), "conv0.bias": (d,)}
    for n in range(1, 4):
        cout = d * min(2 ** n, 8)
        s[f"conv{n}.weight"] = (cout, d * min(2 ** (n - 1), 8), 4, 4)
        s[f"conv{n}.bias"] = (cout,)
    s["conv4.weight"] = (1, d * 8, 4, 4)
    s["conv4.bias"] = (1,)
    return s


def _conv(a: Arith, x, p, name, stride=1, padding=0):
    return a.operand(F.conv2d(a.operand(x), a.operand(p[f"{name}.weight"]),
                              p[f"{name}.bias"], stride=stride, padding=padding))


def _convt(a: Arith, x, p, name):
    return a.operand(F.conv_transpose2d(a.operand(x), a.operand(p[f"{name}.weight"]),
                                        p[f"{name}.bias"], stride=2, padding=1,
                                        output_padding=1))


def _norm(x):
    return F.instance_norm(x, eps=IN_EPS)


def _reflect(x, n):
    return F.pad(x, (n, n, n, n), mode="reflect")


def location_plane(p: dict, embeds: torch.Tensor, h: int, w: int,
                   a: Arith = PLAIN) -> torch.Tensor:
    """(B, 256) -> (B, 1, w, h): the dense layer to a 128^2 plane (``a``'s
    operand rule on its input, weight and output), bilinearly resized
    (half-pixel centres) to the swapped size."""
    plane = a.operand(F.linear(a.operand(embeds), a.operand(p["fc.weight"]), p["fc.bias"]))
    plane = plane.reshape(-1, 1, 128, 128)
    return F.interpolate(plane, size=(w, h), mode="bilinear", align_corners=False)


def blocks(p: dict, h: torch.Tensor, cfg: dict, a: Arith = PLAIN, taps=None) -> torch.Tensor:
    """The residual trunk in float; ``taps`` (a dict) collects each block's
    input and its first norm's output (after the ReLU) by name."""
    for b in range(n_blocks(cfg)):
        if taps is not None:
            taps[f"in{b}"] = h
        t = F.relu(_norm(_conv(a, _reflect(h, 1), p, f"r{b}.conv1")))
        if taps is not None:
            taps[f"mid{b}"] = t
        h = h + _norm(_conv(a, _reflect(t, 1), p, f"r{b}.conv2"))
    return h


def generator(p: dict, x: torch.Tensor, cfg: dict, a: Arith = PLAIN,
              embeds=None, trunk=None) -> torch.Tensor:
    """x (B, Cin, H, W) -> (B, Cout, H, W) in [-1, 1]; ``trunk(p, h)``
    replaces the float residual trunk (the int8 serving trunk)."""
    h = F.relu(_norm(_conv(a, _reflect(x, 3), p, "c0")))
    h = _norm(_conv(a, h, p, "d0", 2, 1))
    if inject(cfg):
        plane = location_plane(p, embeds, h.shape[2], h.shape[3])
        h = h * (1.0 + p["scale_param"] * plane) if "scale_param" in p else h * plane
    h = F.relu(h)
    h = F.relu(_norm(_conv(a, h, p, "d1", 2, 1)))
    h = blocks(p, h, cfg, a) if trunk is None else trunk(p, h)
    h = F.relu(_norm(_convt(a, h, p, "u0")))
    h = F.relu(_norm(_convt(a, h, p, "u1")))
    return a.output(torch.tanh(_conv(a, _reflect(h, 3), p, "c1")))


def pad_amount(cfg: dict) -> int:
    data = cfg["Data"]
    return int(data["padding_amount"]) if data["padding"] else 0


def g_apply(p: dict, rgb: torch.Tensor, cfg: dict, a: Arith = PLAIN,
            embeds=None, trunk=None) -> torch.Tensor:
    """The padded forward: reflect-pad by ``Data.padding_amount``, G, crop."""
    pad = pad_amount(cfg)
    y = generator(p, _reflect(rgb, pad) if pad else rgb, cfg, a, embeds, trunk)
    return y[:, :, pad:-pad, pad:-pad] if pad else y


def discriminator(p: dict, x: torch.Tensor, a: Arith = PLAIN) -> torch.Tensor:
    h = F.leaky_relu(_conv(a, x, p, "conv0", 2, 1), 0.2)
    for n, stride in ((1, 2), (2, 2), (3, 1)):
        h = F.leaky_relu(_norm(_conv(a, h, p, f"conv{n}", stride, 1)), 0.2)
    return _conv(a, h, p, "conv4", 1, 1)


def _mse(x, target: float):
    return torch.mean(torch.square(x - target))


def adam(params: dict, cfg: dict) -> torch.optim.Adam:
    bc = cfg["base_configs"]
    return torch.optim.Adam(list(params.values()), lr=float(bc["lr"]),
                            betas=(float(bc["beta1"]), 0.999), eps=1e-8)


def train_step(pg: dict, pd: dict, opt_g, opt_d, rgb: torch.Tensor,
               nir: torch.Tensor, cfg: dict, a: Arith = PLAIN,
               chunk: int = 4) -> tuple:
    """One fused step on reflectance rgb (B, 3, H, W), nir (B, 1, H, W);
    the batch goes through in chunks of ``chunk`` images (the norms are per
    image and each loss a mean, so the chunks' scaled losses add up to the
    batch's).  Returns (D loss, G loss) as floats and leaves each leaf's
    gradient of this step in ``.grad``."""
    bc = cfg["base_configs"]
    lam_gan, lam_l1 = float(bc["lambda_GAN"]), float(bc["lambda_L1"])
    halve = 0.5 if bc.get("legacy_halve_d_loss", False) else 1.0
    b = rgb.shape[0]
    parts = [slice(i, min(i + chunk, b)) for i in range(0, b, chunk)]
    with torch.no_grad():
        fakes = [g_apply(pg, rgb[s], cfg, a) for s in parts]
    opt_d.zero_grad(set_to_none=True)
    loss_d = 0.0
    for s, fake in zip(parts, fakes):
        w = (s.stop - s.start) / b
        ld = (_mse(discriminator(pd, torch.cat([rgb[s], fake], 1), a), 0.0)
              + _mse(discriminator(pd, torch.cat([rgb[s], nir[s]], 1), a), 1.0)) * halve
        (ld * w).backward()
        loss_d += float(ld.detach()) * w
    opt_d.step()
    frozen = {k: v.detach() for k, v in pd.items()}
    opt_g.zero_grad(set_to_none=True)
    loss_g = 0.0
    for s in parts:
        w = (s.stop - s.start) / b
        pred = g_apply(pg, rgb[s], cfg, a)
        lg = (_mse(discriminator(frozen, torch.cat([rgb[s], pred], 1), a), 1.0) * lam_gan
              + torch.mean(torch.abs(pred - nir[s])) * lam_l1)
        (lg * w).backward()
        loss_g += float(lg.detach()) * w
    opt_g.step()
    return loss_d, loss_g
