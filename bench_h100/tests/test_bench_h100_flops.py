"""The analytic counts against hand reckoning."""

from __future__ import annotations

import pytest

from bench_h100 import flops

S2 = {"batch": 16, "tile": 512, "side": 532, "ngf": 64, "ndf": 64, "n_blocks": 9,
      "n_layers_D": 3, "input_nc": 3, "output_nc": 1, "inject": False}


def test_generator_layers_at_532():
    g = dict(flops.generator(532))
    # c7s1-64 on 532^2 of 3 channels: 2 * 49 * 3 * 64 * 532^2
    assert g["c0"] == 2 * 49 * 3 * 64 * 283024
    # d128 at 266^2, d256 at 133^2: 2 * 9 * 64 * 128 * 70756, 2 * 9 * 128 * 256 * 17689
    assert g["d0"] == 10_433_396_736 and g["d1"] == 10_433_396_736
    # a trunk conv: 2 * 9 * 256 * 256 * 17689 = 20,866,793,472
    assert g["r0.conv1"] == g["r8.conv2"] == 20_866_793_472
    assert g["u0"] == g["d1"] and g["u1"] == g["d0"]
    assert g["c1"] == 2 * 49 * 64 * 283024
    assert sum(g.values()) == pytest.approx(424.44e9, rel=1e-4)
    assert "fc" in dict(flops.generator(532, inject=True))


def test_discriminator_at_512():
    d = dict(flops.discriminator(512))
    assert d["conv0"] == 2 * 16 * 4 * 64 * 256 * 256
    assert d["conv1"] == 2 * 16 * 64 * 128 * 128 * 128
    assert d["conv2"] == 2 * 16 * 128 * 256 * 64 * 64
    assert d["conv3"] == 2 * 16 * 256 * 512 * 63 * 63
    assert d["conv4"] == 2 * 16 * 512 * 1 * 62 * 62


def test_train_step():
    g = sum(f for _, f in flops.generator(532))
    d = sum(f for _, f in flops.discriminator(512))
    c0 = dict(flops.generator(532))["c0"]
    conv0 = dict(flops.discriminator(512))["conv0"]
    # G: forward, weight gradients, input gradients but at c0; D: three
    # forwards, two weight-and-input backwards (no gradient to its input),
    # one input-only backward
    per_image = g + (2 * g - c0) + 3 * d + 2 * (2 * d - conv0) + d
    assert flops.train_step(S2) == pytest.approx(16 * per_image)
    assert flops.train_step(S2) == pytest.approx(23.578e12, rel=1e-4)


def test_bounds():
    # kernel A at the serving batch: operations bound it
    ops = 2 * 9 * 256 * 256 * 133 * 133 * 32
    assert flops.trunk_conv_bound_s(32, 133, 133, 256) == pytest.approx(ops / 989e12)
    # kernel D: the same operations at the int8 peak
    assert flops.int8_conv_bound_s(32, 133, 133, 256) == pytest.approx(ops / 1979e12)
    # a tile's forward at the bf16 peak; with the int8 trunk, its 18 convs
    # at the int8 peak
    assert flops.serve_seconds_at_peak(S2) == pytest.approx(424.44e9 / 989e12, rel=1e-4)
    trunk = 18 * 20_866_793_472
    assert flops.serve_seconds_at_peak(dict(S2, int8_trunk=True)) == pytest.approx(
        (424.44e9 - trunk) / 989e12 + trunk / 1979e12, rel=1e-4)


def test_instance_norm_bytes():
    # G: n0, nd0, nd1, 18 trunk norms (9 with the skip), nu0, nu1; D: three
    # norms, three times each way; B moves 2 (3 with the skip) tensors, B4 3
    b, s = 16, S2
    g = [(532, 64, 0), (266, 128, 0), (133, 256, 0)] + [(133, 256, 0), (133, 256, 1)] * 9 \
        + [(266, 128, 0), (532, 64, 0)]
    d = [(128, 128, 0), (64, 256, 0), (63, 512, 0)]
    want = sum(b * h * h * c * 2 * (2 + k + 3) for h, c, k in g) \
        + 3 * sum(b * h * h * c * 2 * 5 for h, c, _ in d)
    assert flops.instance_norm_bytes_train_step(s) == want
