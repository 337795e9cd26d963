"""The rest of the port's int8 serving trunk against the JAX package's
(``nirgan_tpu/ops/int8_trunk.py``), on the CPU at a small size: kernel D's
plain version in its other gathers (the replicate and zero borders at
stride 1, the zero border at stride 2 of stage 2's d1 conv), kernel E's
mode 3, ``int8_d1_forward``, the stage-2 calibration and pack, and the
int8 generator with stage 2 and with the replicate and zero trunks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from nirgan_tpu.models.generator import ResnetGenerator as JaxResnetGenerator
from nirgan_tpu.ops import int8_trunk as jax_int8
from nirgan_tpu_torch.models import ResnetGenerator
from nirgan_tpu_torch.ops import int8_trunk as port_int8
from nirgan_tpu_torch.weights import params_from_jax
from tests.test_torch_int8 import _as_torch, _jax_args, _port_args, _psnr

NGF, N_BLOCKS, SIZE = 16, 4, 64


def _jax_conv(x8, w8, border, stride):
    """JAX's int32 accumulator: ``_conv_i8(_pad2d(x8))`` at stride 1,
    ``int8_d1_forward``'s strided conv at stride 2."""
    wj = jnp.asarray(w8.transpose(2, 3, 1, 0))
    if stride == 1:
        return np.asarray(jax_int8._conv_i8(jax_int8._pad2d(jnp.asarray(x8), border), wj))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x8), wj, (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))


# ------------------------------------------------------- kernel D, plain
@pytest.mark.parametrize("border,stride,shape,co", [
    ("replicate", 1, (2, 7, 9, 32), 16),
    ("zero", 1, (2, 7, 9, 32), 16),
    ("replicate", 1, (1, 1, 5, 64), 24),
    ("zero", 2, (2, 7, 9, 32), 16),    # odd sides: the far edge is read
    ("zero", 2, (2, 8, 10, 32), 16),   # even sides: it is not
    ("zero", 2, (1, 13, 6, 128), 40),
])
def test_plain_int8_conv_other_gathers_exact_against_jax(border, stride, shape, co):
    """The float64 convolution of int8 values in every gather the JAX int8
    code uses equals JAX's int32 accumulator exactly, at random values and
    at the largest sums; the output side is (H - 1) // 2 + 1 at stride 2,
    the staged bf16 accumulator equals JAX's, and the moments agree to
    1e-6."""
    rng = np.random.default_rng(7)
    ci = shape[3]
    x8 = rng.integers(-127, 128, shape).astype(np.int8)
    w8 = rng.integers(-127, 128, (co, ci, 3, 3)).astype(np.int8)
    extreme = (np.full(shape, 127, np.int8), np.full((co, ci, 3, 3), -127, np.int8))
    for xa, wa in ((x8, w8), extreme):
        ref = _jax_conv(xa, wa, border, stride)
        got = port_int8.conv_i8_plain(torch.from_numpy(xa), torch.from_numpy(wa),
                                      border, stride)
        assert got.dtype == torch.int32
        assert tuple(got.shape) == (shape[0], port_int8.out_side(shape[1], stride),
                                    port_int8.out_side(shape[2], stride), co)
        np.testing.assert_array_equal(got.numpy(), ref)
    hb, m = port_int8.conv_moments_plain(torch.from_numpy(x8), torch.from_numpy(w8),
                                         border, stride)
    np.testing.assert_array_equal(
        hb.float().numpy(), np.asarray(jnp.asarray(_jax_conv(x8, w8, border, stride),
                                                   jnp.float32).astype(jnp.bfloat16),
                                       np.float32))
    a32 = _jax_conv(x8, w8, border, stride).astype(np.float64)
    np.testing.assert_allclose(m[:, 1].numpy(), np.square(a32).sum(axis=(1, 2)), rtol=1e-6)
    scale = float(np.sqrt(np.square(a32).sum(axis=(1, 2)).max() * a32[0, ..., 0].size))
    np.testing.assert_allclose(m[:, 0].numpy(), a32.sum(axis=(1, 2)), rtol=1e-6,
                               atol=1e-6 * scale)


def test_out_side_is_the_strided_conv_s():
    for n in range(1, 12):
        assert port_int8.out_side(n, 1) == n
        assert port_int8.out_side(n, 2) == (n + 2 - 3) // 2 + 1


def test_gather_codes_match_the_kernel_header():
    """The wrapper's gather codes are ``igemm::Gather``'s."""
    import re

    from nirgan_tpu_torch.ops import _lib

    text = (_lib.CSRC / "igemm_wgmma.h").read_text()
    codes = {name: int(v) for name, v in re.findall(r"(\w+) = (\d+),", text)}
    assert port_int8.GATHERS == {("reflect", 1): codes["CONV_REFLECT"],
                                 ("replicate", 1): codes["CONV_REPLICATE"],
                                 ("zero", 1): codes["CONV_ZERO"],
                                 ("zero", 2): codes["STRIDE2_ZERO"],
                                 ("valid", 1): codes["CONV_VALID"],
                                 ("valid", 2): codes["STRIDE2_VALID"]}


# ------------------------------------------------------- kernel E, plain
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_norm_mode3_matches_jax(dtype, jdtype):
    """Mode 3 against ``relu(_norm_from_moments(...)).astype(dtype)`` and
    the trunk's first ``_q8`` of that rounded stream: the stream within
    2e-6 relative or two f32 steps at its magnitude (5e-7; rsqrt may round
    otherwise in the two stacks), the int8 outputs equal but for single
    steps on at most 1% of them."""
    rng = np.random.default_rng(8)
    x8 = rng.integers(-127, 128, (2, 9, 7, 32)).astype(np.int8)
    w8 = rng.integers(-127, 128, (24, 32, 3, 3)).astype(np.int8)
    hb, m = port_int8.conv_moments_plain(torch.from_numpy(x8), torch.from_numpy(w8),
                                         "zero", 2)
    hbj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    eps = (1e-5 / rng.uniform(100, 300, 24) ** 2).astype(np.float32)
    s = rng.uniform(0.01, 0.05, 24).astype(np.float32)
    y = jax_int8._norm_from_moments(hbj, jnp.asarray(m[:, 0].numpy()),
                                    jnp.asarray(m[:, 1].numpy()), jnp.asarray(eps),
                                    hb.shape[1] * hb.shape[2])
    ref = jax.nn.relu(y).astype(jdtype)
    out, q = port_int8.norm_quant_plain(3, hb, torch.from_numpy(s), m,
                                        torch.from_numpy(eps), dtype=dtype)
    assert out.dtype == dtype and q.dtype == torch.int8
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-6, atol=5e-7)
    d = np.abs(q.numpy().astype(int) - np.asarray(
        jax_int8._q8(ref.astype(jnp.float32) / jnp.asarray(s))).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2
    # the quantised input is the rounded stream's own
    assert torch.equal(q, port_int8.quantize_plain(out, torch.from_numpy(s)))


# ------------------------------------------------------------- stage 2
@pytest.fixture(scope="module", params=["plain", "inject"])
def generators(request):
    """(the JAX generator, its params, the port's on the same weights, x,
    embeds or None) at ngf 16, 4 blocks, 64^2, f32."""
    inject = request.param == "inject"
    g = JaxResnetGenerator(input_nc=3, output_nc=1, ngf=NGF, n_blocks=N_BLOCKS,
                           inject=inject, compute_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = (rng.random((2, SIZE, SIZE, 3), dtype=np.float32) * 0.3)
    e = rng.standard_normal((2, 256)).astype(np.float32) if inject else None
    params = jax.device_get(g.init(jax.random.PRNGKey(0), *_jax_args(x, e))["params"])
    port = ResnetGenerator(3, 1, NGF, n_blocks=N_BLOCKS, inject=inject).eval()
    port.load_state_dict(params_from_jax(params), strict=True)
    return g, params, port, x, e


def test_stage2_calibration_and_pack_match_jax(generators):
    """``calibrate_trunk(stage2=True)`` taps the input of d1 (the ReLU'd
    stream after nd0 and the inject combination) as JAX's ``d1_in``: rtol
    1e-5 (float forwards summed in other orders); given JAX's scales,
    ``quantize_trunk``'s ``d1`` pack equals JAX's exactly."""
    g, params, port, x, e = generators
    ref = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e), stage2=True)
    got = port_int8.calibrate_trunk(port, *_port_args(x, e), stage2=True)
    assert "d1_in" not in port_int8.calibrate_trunk(port, *_port_args(x, e))
    assert tuple(got["d1_in"].shape) == (2 * NGF,)
    np.testing.assert_allclose(got["d1_in"].numpy(), np.asarray(ref["d1_in"]), rtol=1e-5)
    for key in ("in", "mid"):
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    qp = jax_int8.quantize_trunk(params, N_BLOCKS, ref)
    calib = _as_torch({k: v for k, v in ref.items() if k != "d1_in"})
    calib["d1_in"] = torch.from_numpy(np.asarray(ref["d1_in"]))
    pack = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS, calib)
    np.testing.assert_array_equal(pack["d1"]["w"].numpy(),
                                  np.asarray(qp["d1"]["w"]).transpose(3, 2, 0, 1))
    for key in ("eps", "s_in"):
        np.testing.assert_array_equal(pack["d1"][key].numpy(), np.asarray(qp["d1"][key]))


@pytest.mark.parametrize("side", [32, 33])
def test_int8_d1_forward_matches_jax(generators, side):
    """``int8_d1_forward`` in f32 on JAX's pack against JAX's on the same
    stream: the conv is exact, so the stream differs only where rsqrt rounds
    otherwise (rtol 2e-6, atol 5e-7 as the norm modes); the trunk's first
    quantised input equals JAX's ``_q8`` of that stream but for single steps
    on at most 1% of the values.  At an odd side the stride-2 conv reads the
    far zero border."""
    g, params, port, x, e = generators
    ref_calib = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e), stage2=True)
    qp = jax_int8.quantize_trunk(params, N_BLOCKS, ref_calib)
    pack = port_int8.quantize_trunk(
        port.state_dict(), N_BLOCKS,
        {**_as_torch({k: v for k, v in ref_calib.items() if k != "d1_in"}),
         "d1_in": torch.from_numpy(np.asarray(ref_calib["d1_in"]))})
    h = np.maximum(np.random.default_rng(9).standard_normal((2, side, side, 2 * NGF)), 0)
    h = (h * np.asarray(ref_calib["d1_in"]) * 40).astype(np.float32)
    ref = np.asarray(jax_int8.int8_d1_forward(jnp.asarray(h), qp["d1"]))
    out, q = port_int8.int8_d1_forward(torch.from_numpy(h), pack["d1"], pack["s_in"][0])
    n = (side - 1) // 2 + 1
    assert tuple(out.shape) == ref.shape == (2, n, n, 4 * NGF)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=5e-7)
    d = np.abs(q.numpy().astype(int) - np.asarray(
        jax_int8._q8(jnp.asarray(ref) / qp["s_in"][0])).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2


def _same_pack(port, params, g, x, e, stage2):
    calib = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e), stage2=stage2)
    qp = jax_int8.quantize_trunk(params, N_BLOCKS, calib)
    tc = _as_torch({k: v for k, v in calib.items() if k != "d1_in"})
    if stage2:
        tc["d1_in"] = torch.from_numpy(np.asarray(calib["d1_in"]))
    return qp, port_int8.quantize_trunk(port.state_dict(), N_BLOCKS, tc)


def test_int8_generator_with_stage2_matches_jax(generators):
    """The int8 generator with stage 2, port against JAX on JAX's pack:
    >= 45 dB (the bound of ``test_int8_generator_matches_jax`` where a
    quantised value rounds the other way on a 1e-6 difference); against its
    own float path >= 36 dB, as JAX holds itself
    (``tests/test_int8_trunk.py``); the stage-2 forward differs from the
    trunk-only one, so d1 ran in int8."""
    g, params, port, x, e = generators
    qp, pack = _same_pack(port, params, g, x, e, stage2=True)
    assert "d1" in pack and "d1" in qp
    ref = np.asarray(g.apply({"params": params}, *_jax_args(x, e), train=False,
                             trunk_q=qp))
    flt = np.asarray(g.apply({"params": params}, *_jax_args(x, e), train=False))
    with torch.no_grad():
        got = port(*_port_args(x, e), trunk_q=pack).numpy()
        trunk_only = port(*_port_args(x, e), trunk_q={k: v for k, v in pack.items()
                                                      if k != "d1"}).numpy()
    print(f"stage 2: {_psnr(got, ref):.1f} dB against JAX; int8 vs float: port "
          f"{_psnr(got, flt):.1f}, JAX {_psnr(ref, flt):.1f} dB")
    assert got.shape == ref.shape == (2, SIZE, SIZE, 1)
    assert _psnr(got, ref) >= 45.0
    assert _psnr(got, flt) >= 36.0 and _psnr(ref, flt) >= 36.0
    assert not np.array_equal(got, trunk_only)


@pytest.mark.parametrize("padding", ["replicate", "zero"])
def test_padded_int8_generator_matches_jax(padding):
    """The int8 generator with the replicate or zero trunk (JAX pads the s8
    stream by edge or zeros, kernel D gathers that border), port against
    JAX on JAX's pack, with and without stage 2: >= 45 dB; each against its
    own float path >= 36 dB (``tests/test_int8_trunk.py``'s bound)."""
    g = JaxResnetGenerator(input_nc=3, output_nc=1, ngf=NGF, n_blocks=N_BLOCKS,
                           padding_type=padding, compute_dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = (rng.random((2, SIZE, SIZE, 3), dtype=np.float32) * 0.3)
    params = jax.device_get(g.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = ResnetGenerator(3, 1, NGF, n_blocks=N_BLOCKS, padding_type=padding).eval()
    port.load_state_dict(params_from_jax(params), strict=True)
    flt = np.asarray(g.apply({"params": params}, jnp.asarray(x), train=False))
    for stage2 in (False, True):
        qp, pack = _same_pack(port, params, g, x, None, stage2)
        ref = np.asarray(g.apply({"params": params}, jnp.asarray(x), train=False,
                                 trunk_q=qp))
        with torch.no_grad():
            got = port(torch.from_numpy(x), trunk_q=pack).numpy()
            got_float = port(torch.from_numpy(x)).numpy()
        print(f"{padding} trunk, stage 2 {stage2}: {_psnr(got, ref):.1f} dB against "
              f"JAX; int8 vs float: port {_psnr(got, got_float):.1f}, JAX "
              f"{_psnr(ref, flt):.1f} dB")
        assert _psnr(got, ref) >= 45.0
        assert _psnr(got, got_float) >= 36.0 and _psnr(ref, flt) >= 36.0
