"""The port's int8 serving trunk against the JAX package's
(``nirgan_tpu/ops/int8_trunk.py``), on the CPU at a small size: the
quantised weights, the calibration, the exact int8 convolution, the norm
from moments, the trunk and the whole int8 generator on the plain and the
inject route, the task's lazy calibration, bulk serving and the CLI with
``--quant int8``, the refusals; and the routing rule that sends a width no
kernel is built for to its op's library route."""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.models.generator import ResnetGenerator as JaxResnetGenerator
from nirgan_tpu.ops import int8_trunk as jax_int8
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch import create_synthetic_dataset as cli
from nirgan_tpu_torch.inference import synthesize_dataset
from nirgan_tpu_torch.models import ResnetGenerator, define_G
from nirgan_tpu_torch.ops import _lib, convt_bwd, head_conv, instance_norm, trunk_conv
from nirgan_tpu_torch.ops import int8_trunk as port_int8
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.weights import params_from_jax
from tests.conftest import REPO_ROOT
from tests.test_inference import _TinySRDataset

NGF, N_BLOCKS, SIZE = 16, 4, 64


def _psnr(a, b, peak_to_peak=2.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return np.inf if mse == 0 else 10 * np.log10(peak_to_peak ** 2 / mse)


def _as_torch(calib):
    return {k: [torch.from_numpy(np.asarray(v)) for v in vs] for k, vs in calib.items()}


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
    args = (jnp.asarray(x),) + ((jnp.asarray(e),) if inject else ())
    params = jax.device_get(g.init(jax.random.PRNGKey(0), *args)["params"])
    port = ResnetGenerator(3, 1, NGF, n_blocks=N_BLOCKS, inject=inject).eval()
    port.load_state_dict(params_from_jax(params), strict=True)
    return g, params, port, x, e


def _jax_args(x, e):
    return (jnp.asarray(x),) + (() if e is None else (jnp.asarray(e),))


def _port_args(x, e):
    return (torch.from_numpy(x),) + (() if e is None else (torch.from_numpy(e),))


# ------------------------------------------------------------ the pack
def test_w8_and_eps_equal_jax_given_the_same_scales(generators):
    """Given the same f32 weights and scales, ``quantize_trunk`` gives JAX's
    int8 weights (HWIO there, (Cout, Cin, 3, 3) here) and eps' exactly."""
    g, params, port, x, e = generators
    calib = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e))
    ref = jax_int8.quantize_trunk(params, N_BLOCKS, calib)
    got = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS, _as_torch(calib))
    for i in range(N_BLOCKS):
        for key in ("w1", "w2"):
            w8 = got[key][i]
            assert w8.dtype == torch.int8 and tuple(w8.shape) == (4 * NGF, 4 * NGF, 3, 3)
            np.testing.assert_array_equal(
                w8.numpy(), np.asarray(ref[key][i]).transpose(3, 2, 0, 1))
        for key in ("eps1", "eps2", "s_in", "s_mid"):
            np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(ref[key][i]))


def test_calibration_scales_match_jax(generators):
    """The hooks read what JAX's captured intermediates give: relu(nd1)'s
    max, the blocks' |x| max, relu(norm1)'s max, with the margin and the
    floor of dead channels; the float forwards sum in other orders, so rtol
    1e-5 (measured 3e-6)."""
    g, params, port, x, e = generators
    ref = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e))
    got = port_int8.calibrate_trunk(port, *_port_args(x, e))
    for key in ("in", "mid"):
        assert len(got[key]) == len(ref[key]) == N_BLOCKS
        for a, b in zip(got[key], ref[key]):
            assert a.dtype == torch.float32 and tuple(a.shape) == (4 * NGF,)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_dead_channel_takes_the_floor():
    """A channel that never fires on the calibration batch is clamped to
    1e-3 of its tensor's largest scale, as JAX's ``clamp``."""
    port = define_G(3, 1, 8, "resnet_6blocks", "instance",
                    generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        port.d1.weight[:4].zero_()  # nd1 of zero-weight channels: 0 after the norm
    x = torch.rand((1, 32, 32, 3))
    calib = port_int8.calibrate_trunk(port, x)
    s = calib["in"][0]
    floor = float(s.max()) * 1e-3
    assert torch.all(s >= floor * (1 - 1e-6))
    assert torch.isclose(s[:4], torch.full((4,), floor)).all()


# ------------------------------------------------------- kernel D, plain
@pytest.mark.parametrize("shape,co", [((2, 7, 9, 32), 16), ((1, 3, 5, 256), 24)])
def test_plain_int8_conv_is_exact_against_jax(shape, co):
    """The float64 convolution of int8 values equals JAX's int32
    accumulator exactly, at the largest sums too (every value 127 or -127:
    |acc| = 127^2 * 9 * Cin, 3.7e7 at Cin 256, beyond f32's 2^24); the
    staged bf16 accumulator equals JAX's and the moments agree to 1e-6."""
    rng = np.random.default_rng(3)
    ci = shape[3]
    x8 = rng.integers(-127, 128, shape).astype(np.int8)
    w8 = rng.integers(-127, 128, (co, ci, 3, 3)).astype(np.int8)
    extreme = (np.full(shape, 127, np.int8), np.full((co, ci, 3, 3), -127, np.int8))
    for xa, wa in ((x8, w8), extreme):
        ref = np.asarray(jax_int8._conv_i8(jax_int8._pad2d(jnp.asarray(xa), "reflect"),
                                           jnp.asarray(wa.transpose(2, 3, 1, 0))))
        got = port_int8.conv_i8_plain(torch.from_numpy(xa), torch.from_numpy(wa))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(np.abs(ref).max()) == 127 * 127 * 9 * ci
    rhb, rm1, rm2 = jax_int8._conv_moments(
        jax_int8._pad2d(jnp.asarray(x8), "reflect"), jnp.asarray(w8.transpose(2, 3, 1, 0)))
    hb, m = port_int8.conv_moments_plain(torch.from_numpy(x8), torch.from_numpy(w8))
    np.testing.assert_array_equal(hb.float().numpy(), np.asarray(rhb, np.float32))
    np.testing.assert_allclose(m[:, 0].numpy(), np.asarray(rm1), rtol=1e-6,
                               atol=1e-6 * float(np.sqrt(np.asarray(rm2).max() * 63)))
    np.testing.assert_allclose(m[:, 1].numpy(), np.asarray(rm2), rtol=1e-6)


# ------------------------------------------------------- kernel E, plain
def test_norm_modes_match_jax():
    """E's three modes against JAX's ``_norm_from_moments`` and ``_q8`` on
    the same staged accumulator and moments: the same f32 operations in the
    same order, but rsqrt may round otherwise in the two stacks: the stream
    within 2e-6 relative or two f32 steps at its magnitude (5e-7), the int8
    outputs equal but for single steps on at
    most 1% of them (none at mode 1 here)."""
    rng = np.random.default_rng(4)
    x8 = rng.integers(-127, 128, (2, 6, 7, 32)).astype(np.int8)
    w8 = rng.integers(-127, 128, (24, 32, 3, 3)).astype(np.int8)
    hb, m = port_int8.conv_moments_plain(torch.from_numpy(x8), torch.from_numpy(w8))
    hbj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    m1, m2 = jnp.asarray(m[:, 0].numpy()), jnp.asarray(m[:, 1].numpy())
    eps = (1e-5 / rng.uniform(100, 300, 24) ** 2).astype(np.float32)
    s = rng.uniform(0.01, 0.05, 24).astype(np.float32)
    y = jax_int8._norm_from_moments(hbj, m1, m2, jnp.asarray(eps), 42)
    st, et = torch.from_numpy(s), torch.from_numpy(eps)
    q1 = port_int8.norm_quant_plain(1, hb, st, m, et)
    np.testing.assert_array_equal(
        q1.numpy(), np.asarray(jax_int8._q8(jax.nn.relu(y) / jnp.asarray(s))))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xs = torch.from_numpy(rng.standard_normal((2, 6, 7, 24)).astype(np.float32))
        xs = xs.to(dtype)
        out, q2 = port_int8.norm_quant_plain(2, hb, st, m, et, xs)
        ref = jnp.asarray(xs.float().numpy()).astype(jdtype) + y.astype(jdtype)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=2e-6, atol=5e-7)
        d = np.abs(q2.numpy().astype(int) - np.asarray(
            jax_int8._q8(ref.astype(jnp.float32) / jnp.asarray(s))).astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-2
        q0 = port_int8.norm_quant_plain(0, xs, st)
        np.testing.assert_array_equal(
            q0.numpy(), np.asarray(jax_int8._q8(
                jnp.asarray(xs.float().numpy()).astype(jdtype).astype(jnp.float32)
                / jnp.asarray(s))))
    last, none = port_int8.norm_quant_plain(2, hb, None, m, et, xs)
    assert none is None and torch.equal(last, out)


# ---------------------------------------------------------- the trunk
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_int8_trunk_matches_jax(generators, dtype, jdtype):
    """The trunk alone on the same input stream and the same pack: >= 60 dB
    (measured 147 dB in f32); how many quantised inputs of the blocks
    differ is counted (0 in f32 at this size)."""
    g, params, port, x, e = generators
    calib = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e))
    qp = jax_int8.quantize_trunk(params, N_BLOCKS, calib)
    pack = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS, _as_torch(calib))
    h = np.maximum(np.random.default_rng(5).standard_normal((2, 16, 16, 4 * NGF)), 0)
    h = h.astype(np.float32)
    ref = np.asarray(jax_int8.int8_trunk_forward(jnp.asarray(h).astype(jdtype), qp),
                     np.float32)
    got = port_int8.int8_trunk_forward(torch.from_numpy(h).to(dtype), pack).float().numpy()
    peak = float(np.abs(ref).max())
    db = _psnr(got, ref, peak)
    # the first block's quantised input, then each block's output
    x8 = port_int8.quantize_plain(torch.from_numpy(h).to(dtype), pack["s_in"][0])
    x8j = jax_int8._q8(jnp.asarray(h).astype(jdtype).astype(jnp.float32) / qp["s_in"][0])
    flips = int((x8.numpy() != np.asarray(x8j)).sum())
    print(f"int8 trunk {dtype}: {db:.1f} dB against JAX, {flips} of {x8.numel()} "
          "quantised inputs of block 0 differ")
    assert db >= 60.0 and flips == 0


def test_int8_generator_matches_jax(generators):
    """The whole int8 generator, port against JAX.  With JAX's pack: the
    quantised input of block 0 is counted where the two float stems (122 dB
    apart) round it apart; with none differing, >= 60 dB (measured 135 dB,
    inject); one flip, from a 2e-6 difference on a value 8e-6 from a rounding
    boundary, passes on through every block (measured 51 dB, plain), so then
    >= 45 dB on at most 1e-3 of them.  Each calibrating on the same input as
    a user's serving would: >= 45 dB (measured 48.9 plain); both against
    their own float path >= 36 dB, as JAX holds itself."""
    g, params, port, x, e = generators
    calib = jax_int8.calibrate_trunk(g, params, *_jax_args(x, e))
    qp = jax_int8.quantize_trunk(params, N_BLOCKS, calib)
    ref = np.asarray(g.apply({"params": params}, *_jax_args(x, e), train=False,
                             trunk_q=qp))
    flt, inter = g.apply({"params": params}, *_jax_args(x, e), train=False,
                         capture_intermediates=True, mutable=["intermediates"])
    flt = np.asarray(flt)
    stem = {}
    hook = port.nd1.register_forward_hook(lambda m, a, out: stem.update(nd1=out))
    with torch.no_grad():
        pack = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS,
                                        port_int8.calibrate_trunk(port, *_port_args(x, e)))
        got = port(*_port_args(x, e), trunk_q=pack).numpy()
        got_float = port(*_port_args(x, e)).numpy()
        jax_pack = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS, _as_torch(calib))
        same_pack = port(*_port_args(x, e), trunk_q=jax_pack).numpy()
    hook.remove()
    # JAX's nd1 is the norm; its ReLU follows
    jax_nd1 = jax.nn.relu(inter["intermediates"]["nd1"]["__call__"][0])
    x8 = port_int8.quantize_plain(stem["nd1"], jax_pack["s_in"][0]).numpy()
    flips = int((x8 != np.asarray(jax_int8._q8(jax_nd1 / qp["s_in"][0]))).sum())
    w8_differ = sum(int((pack[k][i] != jax_pack[k][i]).sum())
                    for k in ("w1", "w2") for i in range(N_BLOCKS))
    db_same = _psnr(same_pack, ref)
    print(f"int8 generator with JAX's pack: {db_same:.1f} dB against JAX, {flips} of "
          f"{x8.size} quantised inputs of block 0 differ; each calibrating: "
          f"{_psnr(got, ref):.1f} dB ({w8_differ} int8 weights differ); int8 vs "
          f"float: port {_psnr(got, got_float):.1f}, JAX {_psnr(ref, flt):.1f} dB")
    assert got.shape == ref.shape == (2, SIZE, SIZE, 1)
    assert db_same >= (60.0 if flips == 0 else 45.0) and flips <= 1e-3 * x8.size
    assert _psnr(got, ref) >= 45.0
    assert _psnr(got, got_float) >= 36.0 and _psnr(ref, flt) >= 36.0


def test_int8_generator_refusals(generators):
    """Serving only: under autograd, or with a norm other than the
    affine-free instance norm, the pack is refused, as JAX refuses it."""
    g, params, port, x, e = generators
    pack = port_int8.quantize_trunk(port.state_dict(), N_BLOCKS,
                                    port_int8.calibrate_trunk(port, *_port_args(x, e)))
    with pytest.raises(ValueError, match="serving-only"):
        port(*_port_args(x, e), trunk_q=pack)
    none = ResnetGenerator(3, 1, NGF, norm_type="none", n_blocks=N_BLOCKS)
    with torch.no_grad(), pytest.raises(ValueError, match="InstanceNorm"):
        none(torch.from_numpy(x), trunk_q=pack)


# ------------------------------------------------------------ the task
def _config(quant, style=None):
    name = "config_px2px_SatCLIP.yaml" if style else "config_px2px.yaml"
    cfg = load_config(os.path.join(REPO_ROOT, "configs", name))
    bc = cfg.base_configs
    bc.ngf, bc.ndf = 8, 8
    if style:
        cfg.satclip.satclip_style = style
        cfg.satclip.satclip_path = None
        if style == "concat":
            bc.netG = "resnet_6blocks"
    cfg.Data.padding_amount = 2
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.shape_buckets = [64]
    cfg.tpu.serving_quant = quant
    return cfg


def _tasks(quant, style=None):
    """The JAX task with its seeded params bound, and the port's on the
    same generator weights, bound."""
    cfg = _config(quant, style)
    jt = JaxPx2PxTask(cfg)
    state = jt.init_state(seed=0, image_size=64)
    jt.bind(state)
    port = Px2PxTask(cfg, device="cpu", seed=0)
    port.bind(params_from_jax(jax.device_get(state.params_g)))
    return jt, port


@pytest.mark.parametrize("style", [None, "inject", "concat"])
def test_predict_step_int8_matches_jax(style):
    """``predict_step`` with ``serving_quant: int8``: the pack is built on
    the first batch, kept for the next (the same bits again), >= 36 dB from
    the float path and >= 45 dB from JAX's int8 ``predict_step``."""
    jt, port = _tasks("int8", style)
    pf = Px2PxTask(_config("none", style), device="cpu", seed=0)
    pf.bind(port.netG.state_dict())
    assert port.wants_int8_serving() and not pf.wants_int8_serving()
    rng = np.random.default_rng(0)
    # square: the concat route's swapped (W, H) resize fits square maps only
    rgb = rng.random((2, 3, 60, 60), np.float32)
    coords = np.asarray([[9.0, 48.0], [-120.0, 35.0]], np.float32) if style else None
    args = (rgb,) + ((coords,) if style else ())
    assert port._trunk_q is None
    got = port.predict_step(*args)
    pack = port._trunk_q
    assert pack is not None and len(pack["w1"]) == port.netG.n_blocks
    again = port.predict_step(*args)
    assert port._trunk_q is pack
    np.testing.assert_array_equal(got, again)
    ref = jt.predict_step(*args)
    flt = pf.predict_step(*args)
    assert got.shape == ref.shape == (2, 1, 60, 60)
    assert _psnr(got, flt) >= 36.0 and _psnr(got, ref) >= 45.0


def test_bind_forces_a_recalibration():
    port = Px2PxTask(_config("int8"), device="cpu", seed=0)
    rgb = np.random.default_rng(2).random((2, 3, 64, 64), np.float32)
    first = port.predict_step(rgb)
    pack = port._trunk_q
    noise = torch.Generator().manual_seed(3)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=noise)
          if k.endswith("conv1.weight") else v
          for k, v in port.netG.state_dict().items()}
    port.bind(sd)
    assert port._trunk_q is None
    second = port.predict_step(rgb)
    assert port._trunk_q is not None and port._trunk_q is not pack
    assert not torch.equal(port._trunk_q["w1"][0], pack["w1"][0])
    assert not np.array_equal(first, second)


def test_int8_is_refused_where_the_config_cannot_take_it():
    cfg = _config("int8")
    cfg.base_configs.norm = "none"
    with pytest.warns(UserWarning, match="int8 ignored"):
        task = Px2PxTask(cfg, device="cpu", seed=0)
    assert not task.wants_int8_serving()
    task.predict_step(np.zeros((1, 3, 64, 64), np.float32))
    assert task._trunk_q is None
    # stage 2 is no config's to take: only build_trunk_q(stage2=True) builds
    # it, as in the JAX package, and the generator then serves d1 in int8
    port = Px2PxTask(_config("int8"), device="cpu", seed=0)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(4)) * 0.3
    pack = port.build_trunk_q(x, stage2=True)
    ngf = port.netG.d1.weight.shape[1] // 2
    assert pack["d1"]["w"].dtype == torch.int8
    assert tuple(pack["d1"]["w"].shape) == (4 * ngf, 2 * ngf, 3, 3)
    assert "d1" not in port.build_trunk_q(x)
    with torch.no_grad():
        xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2),
                                     mode="reflect").permute(0, 2, 3, 1)
        assert _psnr(port.netG(xp, trunk_q=pack).numpy(), port.netG(xp).numpy()) >= 36.0


def test_synthesize_dataset_int8_matches_jax(tmp_path):
    """Bulk serving with the int8 trunk: calibrated once on the first batch,
    every tile written, and within 40 dB of the JAX pipeline's int8 tiles
    over their range (histogram matching maps both onto the S2 values)."""
    from nirgan_tpu.inference import synthesize_dataset as jax_synthesize_dataset

    jt, port = _tasks("int8")
    n = synthesize_dataset(port, _TinySRDataset(), str(tmp_path / "port"),
                           batch_size=2, num_workers=0, num_writers=1)
    assert n == len(_TinySRDataset()) and port._trunk_q is not None
    jax_synthesize_dataset(jt, _TinySRDataset(), str(tmp_path / "jax"), batch_size=2,
                           num_writers=1)
    for f in sorted(os.listdir(tmp_path / "jax")):
        a = np.load(tmp_path / "port" / f)["nir"].astype(np.float32)
        b = np.load(tmp_path / "jax" / f)["nir"].astype(np.float32)
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert _psnr(a, b, float(b.max() - b.min())) >= 40.0, f


def test_cli_quant_int8(tmp_path, capsys):
    """``--quant int8`` overrides ``tpu.serving_quant`` and serves the int8
    trunk through the CLI on the CPU."""
    import yaml

    data = tmp_path / "data"
    for sub in ("HR", "LR"):
        os.makedirs(data / sub)
    rng = np.random.default_rng(0)
    for i in range(2):
        np.savez(data / "HR" / f"t{i}.npz",
                 img=rng.integers(0, 3000, (3, 64, 64), dtype=np.uint16))
        np.savez(data / "LR" / f"t{i}.npz",
                 img=rng.integers(0, 3000, (4, 16, 16), dtype=np.uint16))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config("none").to_dict(), sort_keys=False))
    built = []
    real = Px2PxTask.build_trunk_q

    def spy(self, *a, **k):
        built.append(self.serving_quant)
        return real(self, *a, **k)

    with mock.patch.object(Px2PxTask, "build_trunk_q", spy):
        n = cli.main(["--config", str(cfg), "--data", str(data), "--out",
                      str(tmp_path / "out"), "--ckpt", str(tmp_path / "none.ckpt"),
                      "--device", "cpu", "--batch-size", "2", "--quant", "int8"])
    assert n == 2 and built == ["int8"]
    assert len(os.listdir(tmp_path / "out")) == 2


# ------------------------------------------------- the routing rule, C1
@pytest.mark.parametrize("ngf", [8, 16, 24, 32, 48, 64])
def test_every_width_has_a_route(ngf):
    """For every ngf and ndf that is a multiple of 8 and any output_nc: the
    trunk conv takes kernel A only at the widths it is built for (bf16: Cin
    % 32, Cout % 128; f32: Cin % 16, Cout % 64) and its library route
    elsewhere; the head takes kernel C only at 64 -> 1; every instance norm
    of G and D, both transposed convs' backward and the int8 trunk's conv
    have a kernel at every such width."""
    trunk = 4 * ngf
    for dtype, want in ((torch.bfloat16, trunk % 128 == 0),
                        (torch.float32, trunk % 64 == 0)):
        assert trunk_conv.takes_kernel(dtype, trunk, trunk) == want
    for out_nc in (1, 2, 3):
        assert head_conv.takes_kernel(torch.bfloat16, (out_nc, ngf, 7, 7)) == (
            ngf == 64 and out_nc == 1)
    side = 68
    for c, hw in ((ngf, side), (2 * ngf, side // 2), (trunk, side // 4),
                  (2 * ngf, 32), (4 * ngf, 16), (8 * ngf, 15)):
        for backward in (False, True):
            instance_norm.launch_plan(2, hw * hw, c, 2, backward)
    for ci, co, h in ((trunk, 2 * ngf, 17), (2 * ngf, ngf, 34)):
        convt_bwd.launch_plan(torch.bfloat16, (2, h, h, ci), (2, 2 * h, 2 * h, co),
                              (ci, co, 3, 3))
    assert port_int8.takes_conv(trunk, trunk)


def test_forward_route_by_shape():
    """On a card (the device rule patched to say so) each op names the
    kernel where it is built for the shape and its library route
    elsewhere; on the CPU the plain versions."""
    x64, x48 = torch.zeros((1, 9, 9, 64)), torch.zeros((1, 9, 9, 48))
    w256, w48 = torch.zeros((256, 64, 3, 3)), torch.zeros((48, 48, 3, 3))
    h1, h2 = torch.zeros((1, 64, 7, 7)), torch.zeros((2, 64, 7, 7))
    assert trunk_conv.forward_route(x64, w256) is trunk_conv.trunk_conv_plain
    assert head_conv.forward_route(x64, h1) is head_conv.head_conv_plain
    with mock.patch.object(_lib, "route", return_value=True):
        assert trunk_conv.forward_route(x64.bfloat16(), w256) is trunk_conv.trunk_conv_cuda
        assert trunk_conv.forward_route(x48.bfloat16(), w48) is trunk_conv.trunk_conv_library
        assert trunk_conv.forward_route(x48, w48) is trunk_conv.trunk_conv_library
        assert head_conv.forward_route(x64, h1) is head_conv.head_conv_cuda
        assert head_conv.forward_route(x64, h2) is head_conv.head_conv_library
        assert head_conv.forward_route(x48, torch.zeros((1, 48, 7, 7))) is \
            head_conv.head_conv_library


def test_library_routes_compute_the_plain_function():
    """The library routes are the plain functions in one call each
    (``F.conv2d`` with the bias; then ``torch.tanh`` for the head), counted
    apart; the head's gradient takes any output width."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 9, 8, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 48, 3, 3)).astype(np.float32)) / 20
    b = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    n = trunk_conv.trunk_conv_library.launches
    torch.testing.assert_close(trunk_conv.trunk_conv_library(x, w, b),
                               trunk_conv.trunk_conv_plain(x, w, b), rtol=1e-5, atol=1e-5)
    assert trunk_conv.trunk_conv_library.launches == n + 1
    xp = torch.from_numpy(rng.standard_normal((2, 14, 13, 16)).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal((3, 16, 7, 7)).astype(np.float32)) / 40
    bh = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    n = head_conv.head_conv_library.launches
    torch.testing.assert_close(head_conv.head_conv_library(xp, wh, bh),
                               head_conv.head_conv_plain(xp, wh, bh), rtol=1e-5, atol=1e-5)
    assert head_conv.head_conv_library.launches == n + 1
    bh.requires_grad_(True)
    head_conv.head_conv(xp, wh, bh).sum().backward()
    assert tuple(bh.grad.shape) == (3,)


@pytest.mark.slow
def test_int8_trained_weights_quality():
    """The 43 dB guard of ``tests/test_int8_trunk.py`` on structured
    weights, with the port's own generator in the reference's place: torch's
    default conv initialisation (as the reference's generator has it there),
    25 L1 steps at 96^2, then int8 against float serving on unseen tiles."""
    import math

    from tests.test_visual_parity import _imagery_like_tiles

    torch.manual_seed(0)
    def config(quant):
        cfg = _config(quant)
        cfg.base_configs.ngf, cfg.base_configs.netG = 64, "resnet_9blocks"
        cfg.tpu.shape_buckets = [96]
        return cfg

    task = Px2PxTask(config("int8"), device="cpu", seed=0)
    net = task.netG
    for m in net.modules():
        if hasattr(m, "weight") and m.weight is not None and m.weight.dim() == 4:
            torch.nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5))
            if m.bias is not None:
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                torch.nn.init.uniform_(m.bias, -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
    opt = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.5, 0.999))
    x = _imagery_like_tiles(4, 96, seed=1)
    target = (0.7 * x[:, 1:2] + 0.3 * x[:, 0:1]).clamp(0, 1) * 2 - 1
    xn, tn = x.permute(0, 2, 3, 1), target.permute(0, 2, 3, 1)
    for _ in range(25):
        opt.zero_grad()
        torch.nn.functional.l1_loss(net(xn), tn).backward()
        opt.step()
    net.eval()
    float_task = Px2PxTask(config("none"), device="cpu", seed=0)
    float_task.netG = net
    task.predict_step(_imagery_like_tiles(2, 96, seed=3).numpy())
    unseen = _imagery_like_tiles(2, 96, seed=2).numpy()
    assert _psnr(task.predict_step(unseen), float_task.predict_step(unseen)) > 43.0


def test_int8_wgmma_weight_image_and_rule():
    """Kernel D's wgmma images: for tap t, slice s of 128 channels and
    output channel n, the 16-byte chunk at position p holds the weight's
    channels 128 s + 16 (p ^ n % 8) .. + 16 (the 128-byte swizzle); and the
    shapes that take the wgmma kernel, by the rule written once."""
    rng = np.random.default_rng(7)
    co, ci = 16, 256
    w8 = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3)).astype(np.int8))
    img = port_int8.pack_weight(w8).view(torch.int8)
    assert tuple(img.shape[:3]) == (9, ci // 128, co)
    img = img.reshape(9, ci // 128, co, 8, 16)
    for t in (0, 4, 8):
        for s in range(ci // 128):
            for n in (0, 3, 9, 15):
                for p in range(8):
                    c = 128 * s + 16 * (p ^ (n % 8))
                    want = w8[n, c:c + 16, t // 3, t % 3]
                    assert torch.equal(img[t, s, n, p], want)
    assert port_int8.takes_wgmma(256, 256, 133 * 133)
    assert port_int8.takes_wgmma(128, 128, 16 * 16)
    assert not port_int8.takes_wgmma(128, 128, 15 * 15)  # a tile spans 3 images
    assert not port_int8.takes_wgmma(64, 256, 133 * 133)
    assert not port_int8.takes_wgmma(256, 64, 133 * 133)
    assert port_int8.tile_rows(256) == 128 and port_int8.tile_rows(128) == 256


def _shard_trunk_pixels(n_shards: int, side: int = 2068) -> list[int]:
    """The trunk's output pixels on each shard of an H-sharded tile of
    ``side`` padded rows (parallel/spatial.py): the VALID and STRIDE2_VALID
    gathers both give (rows // 4, side // 4)."""
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    return [(hi - lo) // 4 * (side // 4) for lo, hi in row_ranges(side, n_shards)]


# kernel D's wgmma shapes, (output pixels, Cout): the serving trunk at 4 x
# 532^2 in every stride-1 gather and stage 2's d1 at stride 2 (4 x 133^2 out,
# 553 tiles), a shard's VALID / STRIDE2_VALID slabs of a 2048^2 tile over 2
# and 4 ranks, the N = 128 form, and small odd counts (5 tiles: a cluster
# with an idle CTA; tiles across two images)
_S8_SHAPES = ([(4 * 133 * 133, 256), (4 * 133 * 133, 128), (2 * 27 * 33, 256),
               (3 * 12 * 11, 256), (23 * 27, 256), (3 * 20 * 30, 128), (3 * 14 * 13, 256)]
              + [(m, 256) for n in (2, 4) for m in sorted(set(_shard_trunk_pixels(n)))])


@pytest.mark.parametrize("m,co,sms", [(m, co, sms) for m, co in _S8_SHAPES
                                       for sms in (132, 7, 1)])
def test_int8_wgmma_walk_covers_every_pixel_once(m, co, sms):
    """Kernel D's wgmma walk (``tile_walk`` mirrors the kernel's): every
    output pixel in exactly one tile, tiles on grain boundaries, at most
    one half tile a CTA and only at its end (Cout 256), and no CTA more than
    a grain behind the mean (553 tiles on 132 CTAs: four tiles and a half,
    where whole tiles alone take five)."""
    ctas = port_int8.s8_ctas(m, co, sms)
    bm, gr = port_int8.tile_rows(co), port_int8.grain_rows(co)
    assert 1 <= ctas <= sms
    walk = port_int8.tile_walk(m, co, ctas)
    spans = sorted(t for mine in walk for t in mine)
    assert spans[0][0] == 0 and spans[-1][0] + spans[-1][1] == m
    assert all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(first % gr == 0 and 0 < rows <= bm for first, rows in spans)
    for mine in walk:
        halves = [i for i, (first, rows) in enumerate(mine)
                  if rows <= 64 and first + rows < m]
        assert co == 256 or not halves
        assert halves in ([], [len(mine) - 1])
    grains = -(-m // gr)
    took = [g1 - g0 for g0, g1 in port_int8.grain_runs(m, co, ctas)]
    assert sum(took) == grains and max(took) - min(took) <= 1
    if (m, co, sms) == (4 * 133 * 133, 256, 132):
        assert ctas == 132 and max(took) == 9  # whole tiles alone: 10


@pytest.mark.parametrize("b,ho,wo,co,sms", [
    (4, 133, 133, 256, 132), (1, 259, 517, 256, 132), (4, 133, 133, 128, 132),
    (3, 12, 11, 256, 132), (3, 15, 13, 256, 7), (5, 17, 19, 128, 2),
    (32, 133, 133, 256, 132), (1, 15, 13, 256, 1)])
def test_int8_scratch_holds_each_image_sum_once(b, ho, wo, co, sms):
    """The wgmma kernel's moments scratch has one slot a (CTA, image its
    run touches) pair, slot CTA + image: no two pairs share one, every
    image has at least one, and the scratch holds them all; the mma.sync
    kernel's is (B, tiles of 128 pixels an image, 2, Cout)."""
    m = b * ho * wo
    ctas = port_int8.s8_ctas(m, co, sms)
    shape = port_int8.scratch_shape(b, ho, wo, co, True, ctas)
    assert shape == (ctas + b - 1, 2, 2, co)
    slots = port_int8.image_slots(m, co, ctas, ho * wo)
    flat = [x for mine in slots for x in mine]
    assert len(slots) == b and all(slots)
    assert len(flat) == len(set(flat)) and max(flat) < shape[0]
    assert all(mine == sorted(mine) for mine in slots)
    assert port_int8.scratch_shape(b, ho, wo, co, False) == (b, -(-ho * wo // 128), 2, co)


def test_int8_wgmma_plan_constants_match_the_source():
    """The walk's constants are the kernel's: the grain (a 64-row unit at
    Cout 256, a tile at 128), the CTAs' runs, the slots, and the C entry's
    arguments."""
    import pathlib
    import re

    csrc = pathlib.Path(port_int8.__file__).parent.parent / "csrc"
    header = (csrc / "igemm_wgmma.h").read_text()
    engine = (csrc / "igemm_wgmma.cu").read_text()
    conv = (csrc / "int8_conv.cu").read_text()
    assert "inline int s8_grain(int N) { return N == 256 ? 64 : tile_rows(N); }" in header
    assert port_int8.grain_rows(256) == 64 and port_int8.grain_rows(128) == 256
    assert "g0 = cta * runs.q + (cta < runs.r ? cta : runs.r);" in engine
    assert "g1 = g0 + runs.q + (cta < runs.r ? 1 : 0);" in engine
    assert "const Runs runs{grains / ctas, grains % ctas};" in engine
    assert "((long long)(blockIdx.x + img) * 2 + wg) * 2 * N" in engine
    entry = re.search(r'extern "C" int nirgan_int8_conv\((.*?)\)', conv, re.S).group(1)
    assert len(entry.split(",")) == len(_lib._SIGNATURES["nirgan_int8_conv"])


# ---------------------------------------------------------- kernel E's plan
# kernel E's shapes, (B, pixels an image, C): the serving trunk at 4 x 532^2,
# a shard's trunk of a 2048^2 tile over 2 and 4 ranks (with the tile's
# count), a batch of 1 whose 63 pixels are no multiple of a pass, C = 8
# (one channel group, 256 rows) and C = 2048 (256 groups, one row), fewer
# pixels than a pass, and five images of 221 pixels at C = 64
_NORM_SHAPES = ([(4, 133 * 133, 256)]
                + [(1, m, 256) for n in (2, 4) for m in sorted(set(_shard_trunk_pixels(n)))]
                + [(1, 63, 256), (3, 35, 8), (2, 99, 2048), (2, 9, 128), (5, 221, 64)])


def _norm_runs(hw, blocks):
    """The pixels [p0, p1) of an image each of E's blocks walks, as the
    kernel computes them (``test_int8_norm_plan_constants_match_the_source``
    holds its formula): runs as equal as the pixels allow, the longer ones
    first.  A block never leaves its image."""
    q, r = divmod(hw, blocks)
    return [(i * q + min(i, r), i * q + min(i, r) + q + (i < r)) for i in range(blocks)]


def _norm_walk(hw, c, blocks):
    """The pixels of one image each thread of each of E's blocks visits, as
    the kernel walks them: thread (group, row) of a block covers p0 + row,
    p0 + row + rows, ... below p1 (``norm_pass`` of them a pass), the eight
    channels 8 group to 8 group + 7; every group of a row visits the same
    pixels."""
    rows = port_int8.norm_rows(c)
    return [[range(p0 + r, p1, rows) for r in range(rows)] for p0, p1 in _norm_runs(hw, blocks)]


@pytest.mark.parametrize("b,hw,c,sms", [(b, hw, c, sms) for b, hw, c in _NORM_SHAPES
                                         for sms in (132, 7, 1)])
def test_int8_norm_walk_covers_every_pixel_once(b, hw, c, sms):
    """Kernel E's walk (``_norm_walk`` mirrors the kernel's): each block a
    run of one image's pixels, runs at most a pixel apart, every (pixel,
    channel group) of an image visited by exactly one thread, and one wave
    on the card's slots (5 blocks an SM) where the images allow it."""
    slots = 5 * sms
    per_pass = port_int8.norm_pass(1, 1)
    blocks = port_int8.norm_blocks(b, hw, c, slots, per_pass)
    rows, groups = port_int8.norm_rows(c), c // 8
    assert 1 <= blocks <= hw and rows * groups <= port_int8.NORM_THREADS
    assert blocks * b <= max(slots, b)  # one wave, or a block an image
    assert blocks == min(max(1, slots // b), -(-hw // (per_pass * rows)))
    runs = _norm_runs(hw, blocks)
    assert runs[0][0] == 0 and runs[-1][1] == hw
    assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))
    took = [p1 - p0 for p0, p1 in runs]
    assert min(took) >= 1 and max(took) - min(took) <= 1 and took == sorted(took, reverse=True)
    walk = _norm_walk(hw, c, blocks)
    seen = np.zeros(hw, np.int64)
    for (p0, p1), threads in zip(runs, walk):
        assert len(threads) == rows
        visited = np.concatenate([np.arange(t.start, t.stop, t.step) for t in threads])
        assert visited.size == 0 or (visited.min() >= p0 and visited.max() < p1)
        np.add.at(seen, visited, 1)
    # each thread's pixels are seen by all C / 8 groups of its row, once
    assert (seen == 1).all()
    if (b, hw, c, sms) == (4, 133 * 133, 256, 132):
        assert blocks == 165 and blocks * b == slots


def test_int8_norm_plan_constants_match_the_source():
    """E's plan constants, its run formula and walk, its pass of 64 loaded
    bytes and its C entries' arguments are the kernel's."""
    import pathlib
    import re

    src = (pathlib.Path(port_int8.__file__).parent.parent / "csrc" / "int8_norm.cu").read_text()
    assert f"constexpr int THREADS = {port_int8.NORM_THREADS};" in src
    assert f"constexpr int LOAD_BYTES = {port_int8.NORM_LOAD_BYTES};" in src
    assert "const int per = HW / gridDim.x, longer = HW % gridDim.x;" in src
    assert "const int p0 = blockIdx.x * per + min((int)blockIdx.x, longer);" in src
    assert "const int p1 = p0 + per + ((int)blockIdx.x < longer ? 1 : 0);" in src
    assert "return c8 * (c8 >= THREADS ? 1 : THREADS / c8);" in src
    # _norm_walk's: thread row r from p0 + r, U pixels rows apart a pass
    assert "const int c0 = threadIdx.x % c8 * 8, r = threadIdx.x / c8;" in src
    assert "const int step = U * rows;  // the pixels of a pass" in src
    assert "  int p = p0 + r;\n" in src and "      if (p + u * rows < p1)\n" in src
    assert ("constexpr int bytes = (int)sizeof(Raw8<S>) + (MODE == 2 ? (int)sizeof(Raw8<T>) : 0);"
            in src)
    assert "return LOAD_BYTES / bytes > 0 ? LOAD_BYTES / bytes : 1;" in src
    # (mode, dtype code) -> pixels a pass: 16 bytes a bf16 pixel, 32 an f32 one
    assert {(m, c): port_int8.norm_pass(m, c) for m in range(4) for c in (0, 1)} == {
        (0, 0): 2, (0, 1): 4, (1, 0): 4, (1, 1): 4, (2, 0): 1, (2, 1): 2, (3, 0): 4, (3, 1): 4}
    for name in ("nirgan_int8_norm", "nirgan_int8_norm_blocks_per_sm"):
        args = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
        assert len(args.split(",")) == len(_lib._SIGNATURES[name])


_RINT_MAGIC = np.float32(12582912.0)  # 1.5 * 2^23, int8_norm.cu's RINT_MAGIC


def _nice(s):
    """int8_norm.cu's ``nice``: 2^-64 <= |s| <= 2^64."""
    a = np.abs(np.asarray(s, np.float32))
    with np.errstate(invalid="ignore"):
        return (a >= np.float32(2.0 ** -64)) & (a <= np.float32(2.0 ** 64))


def _q8_near(v, s, t):
    """int8_norm.cu's ``q8_near`` in numpy: t NaN -> 0, |t| >= 128 -> +-127;
    else h, the half-integer nearest t, and the residual e = v - h s, one
    FMA (here the float64 difference, exact, rounded once to float32);
    rint(h) where |e| <= |s| ulp(h) / 2, else h's integer on the side that
    e's sign (times s's) gives.  Returns (q, where e was exact)."""
    v, s, t = (np.asarray(a, np.float32) for a in (v, s, t))
    with np.errstate(all="ignore"):
        n = np.rint(t)
        h = np.where(t >= n, n + np.float32(0.5), n - np.float32(0.5)).astype(np.float32)
        e64 = v.astype(np.float64) - h.astype(np.float64) * s.astype(np.float64)
        e = e64.astype(np.float32)
        ulp = ((np.abs(h).view(np.int32) & 0x7F800000) - (23 << 23)).view(np.float32)
        lo = np.nan_to_num(h - np.float32(0.5)).astype(np.int64)
        on_h = np.abs(e) <= np.abs(s) * (np.float32(0.5) * ulp)
        k = np.where(on_h, lo + (lo % 2), np.where((e > 0) == (s > 0), lo + 1, lo))
        k = np.where(np.abs(t) < 128, k, np.where(t > 0, 127, -127))
        k = np.where(np.isnan(t), 0, k)
        exact = ~np.isfinite(t) | (np.abs(t) >= 128) | (e64 == e.astype(np.float64))
    return np.clip(k, -127, 127).astype(np.int32), exact


def _q8_reference(v, s):
    """E's quotient as a true division, ``clip127(__float2int_rn(v == 0 ? 0
    : __fdiv_rn(v, s)))``: the f32 quotient rounded half to even, clipped
    to +-127, NaN -> 0."""
    v, s = np.asarray(v, np.float32), np.asarray(s, np.float32)
    with np.errstate(all="ignore"):
        x = np.where(v == 0, np.float32(0), v / s)
        return np.clip(np.nan_to_num(np.rint(x), nan=0.0), -127, 127).astype(np.int32)


def _q8_guarded(v, s):
    """Kernel E's quotient in numpy float32 (each product, reciprocal and
    sum one IEEE rounding, as the ``_rn`` intrinsics): t = v * r, r = 1 / s
    rounded, clipped to +-127 and rounded by the add of 1.5 * 2^23 (the
    int8 the low byte of the sum), the guard sending the elements near a
    half-integer to ``_q8_near``; where s is not nice, the true division
    (the kernel's blocks with such a scale divide).  Returns (q, where the
    guard took ``_q8_near``, the bare product's q), after asserting that
    every residual the guard's path used was exact."""
    v, s = np.broadcast_arrays(np.asarray(v, np.float32), np.asarray(s, np.float32))
    with np.errstate(all="ignore"):
        t = v * (np.float32(1) / s)
        c = np.fmin(np.fmax(t, np.float32(-127)), np.float32(127))
        m = c + _RINT_MAGIC
        half = np.float32(0.5) - np.abs(c - (m - _RINT_MAGIC))
        fast = (m.view(np.int32) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        near = ~(half > np.abs(t) * np.float32(2.0 ** -21))
        bare = np.clip(np.nan_to_num(np.rint(t)), -127, 127).astype(np.int32)
    q_near, exact = _q8_near(v, s, t)
    assert exact[near & _nice(s)].all()
    q = np.where(_nice(s), np.where(near, q_near, fast), _q8_reference(v, s))
    return q, near & _nice(s), bare


def _bf16(v):
    """f32 values rounded to bf16 (nearest, ties to even), as f32."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def test_int8_norm_division_guard_equals_the_true_division():
    """The reciprocal with the guard gives ``q8(v / s)`` exactly: on 10^6
    seeded values at calibrated scales (a channel's scale (0.5-1.5) * 3 /
    127, the values to about +-170 steps, past the clip), on the same
    values rounded to bf16 (a bf16 stream in modes 0 and 2), with zeros and
    values far out; on values within +-8 ulp of every half-integer from
    -127.5 to 127.5 at 72 scales (8 negative) and at the nice range's ends, where the
    bare product rounds otherwise than the division and the guard must
    settle them; on exact midpoints between floats beside a half-integer;
    and on the special cases (NaN, infinities, zeros, scales that are not
    nice)."""
    rng = np.random.default_rng(18)
    s = ((rng.random(10 ** 6) + 0.5) * 3.0 / 127).astype(np.float32)
    v = (rng.standard_normal(10 ** 6) * 2.0).astype(np.float32)
    v[:1000] = 0.0
    v[1000:2000] = -0.0
    v[2000:3000] = rng.choice([-1, 1], 1000) * 10.0 ** rng.uniform(3, 30, 1000)
    for values in (v, _bf16(v)):
        q, near, _ = _q8_guarded(values, s)
        assert np.array_equal(q, _q8_reference(values, s))
        # the guard: a few in 10^5 of the values at the trunk's scales
        assert 0 < near[3000:].mean() < 1e-4
    scales = np.concatenate([(rng.random(64) + 0.5) * 3.0 / 127, -(rng.random(8) + 0.5) / 50,
                             [2.0 ** -64, 2.0 ** -63 * 1.7, 2.0 ** 63 * 1.3, 2.0 ** 64]])
    scales = scales.astype(np.float32)
    halves = np.arange(-127.5, 128.0, 1.0, dtype=np.float32)
    v0 = (halves[None, :].astype(np.float64) * scales[:, None]).astype(np.float32)
    steps = np.arange(-8, 9, dtype=np.int32)
    near_v = (v0[..., None].view(np.int32) + steps).view(np.float32)
    sv = np.broadcast_to(scales[:, None, None], near_v.shape)
    q, near, bare = _q8_guarded(near_v, sv)
    ref = _q8_reference(near_v, sv)
    assert np.array_equal(q, ref)
    assert (bare != ref).any() and near.any()
    # quotients exactly on a float midpoint next to a half-integer: s a
    # power of two, v = (h +- half an ulp of h) s
    h = halves.astype(np.float64)
    spacing = np.ldexp(1.0, np.frexp(np.abs(h))[1] - 24)
    for side in (-0.5, 0.5):
        for p2 in (2.0 ** -7, 2.0 ** -3, 0.5):
            vm = ((h + side * spacing) * p2).astype(np.float32)
            assert np.array_equal(_q8_guarded(vm, np.float32(p2))[0],
                                  _q8_reference(vm, np.float32(p2)))
    special_v = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -3.0, 1e-45, 3e38, -2.5],
                         np.float32)
    special_s = np.array([np.nan, np.inf, 0.0, -0.0, 1e-45, 1e-39, 2.0 ** -126, 1e38, 3e38,
                          1.0, 0.02, -0.02], np.float32)
    vs, ss = np.meshgrid(special_v, special_s)
    assert np.array_equal(_q8_guarded(vs, ss)[0], _q8_reference(vs, ss))
