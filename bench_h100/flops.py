"""Analytic operation and byte counts of the pix2pix networks at the shapes
run, and the card's published peaks (NVIDIA H100 SXM data sheet, dense, at
its 700 W limit).

A convolution's operations are 2 k^2 Cin Cout Ho Wo (a multiply and an
add); a 3x3 stride-2 transposed convolution's 2 k^2 Cin Cout Hin Win (every
input pixel scatters k^2 taps).  A backward pass costs the forward's
operations once for the input's gradient (where one is needed) and once for
the weight's (where the weight trains).  Norms, activations, losses and the
optimizer are left out: the model's operations are its convolutions.
Written anew after the pattern of ``generator_flops_per_tile`` in the JAX
harness, and extended to the discriminator, the backward and the int8
trunk.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def conv(cin: int, cout: int, k: int, ho: int, wo: int) -> float:
    return 2.0 * k * k * cin * cout * ho * wo


def down(n: int) -> int:
    """The side after a 3x3 convolution at stride 2 with padding 1."""
    return (n - 1) // 2 + 1


def generator(side: int, ngf: int = 64, n_blocks: int = 9, input_nc: int = 3,
              output_nc: int = 1, inject: bool = False) -> list:
    """[(layer, operations)] of one image through the ResNet generator whose
    (reflect-padded) input is ``side`` square: c7s1-ngf, d2ngf, d4ngf,
    2 n_blocks 3x3 trunk convs, u2ngf, ungf, c7s1-out (and the inject
    route's 256 -> 128^2 dense layer)."""
    s2 = down(down(side))
    layers = [("c0", conv(input_nc, ngf, 7, side, side)),
              ("d0", conv(ngf, 2 * ngf, 3, down(side), down(side))),
              ("d1", conv(2 * ngf, 4 * ngf, 3, s2, s2))]
    layers += [(f"r{i}.conv{j}", conv(4 * ngf, 4 * ngf, 3, s2, s2))
               for i in range(n_blocks) for j in (1, 2)]
    layers += [("u0", conv(4 * ngf, 2 * ngf, 3, s2, s2)),
               ("u1", conv(2 * ngf, ngf, 3, 2 * s2, 2 * s2)),
               ("c1", conv(ngf, output_nc, 7, 4 * s2, 4 * s2))]
    if inject:
        layers.append(("fc", 2.0 * 256 * 128 * 128))
    return layers


def discriminator(side: int, input_nc: int = 4, ndf: int = 64,
                  n_layers: int = 3) -> list:
    """[(layer, operations)] of one image through the PatchGAN: 4x4
    convolutions with padding 1, stride 2 for the first ``n_layers``."""
    def out(h, stride):
        return (h + 2 - 4) // stride + 1

    h = out(side, 2)
    layers = [("conv0", conv(input_nc, ndf, 4, h, h))]
    cin = ndf
    for n in range(1, n_layers + 1):
        cout = ndf * min(2 ** n, 8)
        h = out(h, 2 if n < n_layers else 1)
        layers.append((f"conv{n}", conv(cin, cout, 4, h, h)))
        cin = cout
    h = out(h, 1)
    layers.append((f"conv{n_layers + 1}", conv(cin, 1, 4, h, h)))
    return layers


def train_step(shapes: dict) -> float:
    """Operations of one fused GAN step on a batch: G forward; D on the
    detached fake and on the real pair, both backwards for D's weights (no
    gradient to D's input); D again on the fake, backward to its input
    only; G's backward (no gradient to its input image)."""
    g = generator(shapes["side"], shapes["ngf"], shapes["n_blocks"],
                  shapes["input_nc"], shapes["output_nc"], shapes["inject"])
    d = discriminator(shapes["tile"], shapes["input_nc"] + shapes["output_nc"],
                      shapes["ndf"], shapes["n_layers_D"])
    g_fwd = sum(f for _, f in g)
    d_fwd = sum(f for _, f in d)
    first = dict(g)["c0"]
    fc = dict(g).get("fc", 0.0)
    g_bwd = 2 * g_fwd - first - fc  # no input gradient at c0 or fc
    d_total = 3 * d_fwd + 2 * (d_fwd + d_fwd - d[0][1]) + d_fwd
    return shapes["batch"] * (g_fwd + g_bwd + d_total)


def serve_seconds_at_peak(shapes: dict) -> float:
    """The least time of one tile's generator forward: each layer's
    operations at the peak of the precision it runs in (the residual
    trunk's convs in int8 where ``shapes["int8_trunk"]``)."""
    g = generator(shapes["side"], shapes["ngf"], shapes["n_blocks"],
                  shapes["input_nc"], shapes["output_nc"], shapes["inject"])
    int8 = shapes.get("int8_trunk", False)
    return sum(f / (PEAK_INT8_OPS if int8 and name.startswith("r") else PEAK_BF16_FLOPS)
               for name, f in g)


def trunk_conv_bound_s(b: int, h: int, w: int, c: int) -> float:
    """Kernel A at (b, h, w, c) -> c, bf16: the larger of its operations at
    the bf16 peak and its bytes (input, weight, bias and output once) at the
    memory rate."""
    ops = conv(c, c, 3, h, w) * b
    moved = 2 * b * h * w * c * 2 + 9 * c * c * 2 + c * 4
    return max(ops / PEAK_BF16_FLOPS, moved / PEAK_BYTES_PER_S)


def int8_conv_bound_s(b: int, h: int, w: int, c: int) -> float:
    """Kernel D at (b, h, w, c) -> c: int8 input and weight, bf16 output and
    f64 moments, its operations at the int8 peak."""
    ops = conv(c, c, 3, h, w) * b
    moved = b * h * w * c + 9 * c * c + b * h * w * c * 2 + b * 2 * c * 8
    return max(ops / PEAK_INT8_OPS, moved / PEAK_BYTES_PER_S)


def instance_norm_bytes_train_step(shapes: dict) -> float:
    """Bytes kernels B and B4 must move in one step, bf16: B reads x (and a
    block's skip) and writes y; B4 reads x and the cotangent and writes dx.
    G's 3 + 2 n_blocks + 2 norms run forward once and backward once; D's
    n_layers norms forward three times (fake, real, fake through the
    updated D) and backward three times."""
    b, ngf, side = shapes["batch"], shapes["ngf"], shapes["side"]
    s1, s2 = down(side), down(down(side))
    g = [(side, ngf, False), (s1, 2 * ngf, False), (s2, 4 * ngf, False)]
    for _ in range(shapes["n_blocks"]):
        g += [(s2, 4 * ngf, False), (s2, 4 * ngf, True)]
    g += [(2 * s2, 2 * ngf, False), (4 * s2, ngf, False)]
    d = []
    h, cin = shapes["tile"] // 2, shapes["ndf"]
    for n in range(1, shapes["n_layers_D"] + 1):
        h = (h + 2 - 4) // (2 if n < shapes["n_layers_D"] else 1) + 1
        d.append((h, shapes["ndf"] * min(2 ** n, 8), False))
    total = 0.0
    for layers, times in ((g, 1), (d, 3)):
        for hh, c, skip in layers:
            px = b * hh * hh * c * 2
            total += times * (px * (3 if skip else 2) + 3 * px)
    return total
