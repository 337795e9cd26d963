"""The port's kernels as ``torch.ops.nirgan`` operators and its serving
export (``nirgan_tpu_torch/inference/export.py``) against the JAX package's
(``nirgan_tpu/inference/export.py``), on the CPU at a small size (ngf 8,
``resnet_6blocks`` and the 9-block inject generator, 32^2, batch 2, f32).

Each operator passes ``torch.library.opcheck`` (schema, autograd
registration, fake tensors, AOT dispatch) and equals its plain function bit
for bit; the instance norm's registered gradient is differentiable twice
(``gradgradcheck`` in f64).  The exported plain and inject programs, after
a round trip through bytes on disk, equal JAX's ``run_exported`` on the
same weights (``weights.params_from_jax``) within atol 2e-5, as
``tests/test_inference.py`` holds JAX's artifact to its live path; the int8
artifact equals the port's live int8 forward within 1e-6 and JAX's int8
artifact within the 45 dB that ``tests/test_torch_int8.py`` sets for the
int8 generator (each calibrating its own pack).  A second seed's weights
run through the same artifact, the graph holds the operators the block
count gives, a process with no model code loads and runs an artifact, and
another device is refused.  The kernels themselves run on the card only
(``chip_smoke.py --phase export``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config as jax_load_config
from nirgan_tpu.inference.export import export_generator as jax_export_generator
from nirgan_tpu.inference.export import run_exported as jax_run_exported
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch.config import load_config
from nirgan_tpu_torch.inference import export_generator, load_exported, run_exported
from nirgan_tpu_torch.ops import _registry
from nirgan_tpu_torch.ops import convt_bwd as convt_mod
from nirgan_tpu_torch.ops import head_conv as head_mod
from nirgan_tpu_torch.ops import instance_norm as in_mod
from nirgan_tpu_torch.ops import int8_trunk as int8_mod
from nirgan_tpu_torch.ops import reflect_pad as pad_mod
from nirgan_tpu_torch.ops import trunk_conv as trunk_mod
from nirgan_tpu_torch.ops.conv import _convt_k3s2
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.weights import params_from_jax
from tests.conftest import REPO_ROOT

SIZE, BATCH = 32, 2


def _t(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _cases():
    """(operator, args, the plain function's result) for each operator at a
    small shape, every mode of those that have several."""
    rng = np.random.default_rng(0)
    x, w, b = _t(rng, 2, 6, 5, 16), _t(rng, 32, 16, 3, 3, scale=0.1), _t(rng, 32)
    xn, r = _t(rng, 2, 6, 5, 16, scale=2.0) + 0.5, _t(rng, 2, 6, 5, 16)
    _, stats = in_mod.instance_norm_plain(xn, return_stats=True)
    g = _t(rng, 2, 6, 5, 16)
    xh, wh, bh = _t(rng, 2, 10, 9, 8), _t(rng, 1, 8, 7, 7, scale=0.1), _t(rng, 1)
    z, wt, ct = _t(rng, 1, 5, 4, 8), _t(rng, 8, 4, 3, 3), _t(rng, 1, 10, 8, 4)
    x8 = torch.from_numpy(rng.integers(-127, 128, (2, 7, 6, 32), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (16, 32, 3, 3), dtype=np.int8))
    hb, m = int8_mod.conv_moments_plain(x8, w8)
    eps = torch.from_numpy((1e-5 / (1.0 + rng.random(16)) ** 2).astype(np.float32))
    s = torch.from_numpy((rng.random(16) * 0.05 + 0.01).astype(np.float32))
    stream = _t(rng, 2, 7, 6, 16)
    gp = _t(rng, 2, 7, 6, 16)
    parts = torch.stack([in_mod.instance_norm_sums_plain(xn[:, :2]),
                         in_mod.instance_norm_sums_plain(xn[:, 2:])], 1)
    ops = torch.ops.nirgan
    return {
        "trunk_conv pad 1": (ops.trunk_conv, (x, w, b, 1), trunk_mod.trunk_conv_plain(x, w, b, 1)),
        "trunk_conv pad 0": (ops.trunk_conv, (x, w, None, 0), trunk_mod.trunk_conv_plain(x, w, None, 0)),
        "instance_norm": (ops.instance_norm, (xn, None, 1e-5, True),
                          in_mod.instance_norm_plain(xn, relu=True, return_stats=True)),
        "instance_norm skip": (ops.instance_norm, (xn, r, 1e-5, False),
                               in_mod.instance_norm_plain(xn, residual=r, return_stats=True)),
        "instance_norm_bwd": (ops.instance_norm_bwd, (xn, g, stats, True),
                              in_mod.instance_norm_bwd_plain(xn, g, stats, True)),
        "head_conv": (ops.head_conv, (xh, wh, bh), head_mod.head_conv_plain(xh, wh, bh)),
        "reflect_pad": (ops.reflect_pad, (x,), pad_mod.reflect_pad_plain(x)),
        "reflect_pad_adjoint": (ops.reflect_pad_adjoint, (gp,),
                                pad_mod.reflect_pad_adjoint_plain(gp)),
        "convt_k3s2": (ops.convt_k3s2, (z, wt), _convt_k3s2(z, wt)),
        "convt_k3s2_bwd": (ops.convt_k3s2_bwd, (ct, z, wt, True, True),
                           convt_mod.convt_k3s2_bwd_plain(ct, z, wt)),
        "convt_k3s2_bwd dW": (ops.convt_k3s2_bwd, (ct, z, wt, False, True),
                              convt_mod.convt_k3s2_bwd_plain(ct, z, wt, (False, True))),
        "int8_conv_moments": (ops.int8_conv_moments, (x8, w8, "reflect", 1),
                              int8_mod.conv_moments_plain(x8, w8)),
        "int8_conv_moments s2": (ops.int8_conv_moments, (x8, w8, "zero", 2),
                                 int8_mod.conv_moments_plain(x8, w8, "zero", 2)),
        "instance_norm_sums": (ops.instance_norm_sums, (xn,), in_mod.instance_norm_sums_plain(xn)),
        "instance_norm_apply": (ops.instance_norm_apply, (xn[:, :2], parts, None, 30, 1e-5, True),
                                in_mod.instance_norm_apply_plain(xn[:, :2], parts, 30, relu=True)),
        "instance_norm_apply skip": (ops.instance_norm_apply,
                                     (xn[:, 2:], parts, r[:, 2:], 30, 1e-5, False),
                                     in_mod.instance_norm_apply_plain(xn[:, 2:], parts, 30,
                                                                      residual=r[:, 2:])),
        "int8_conv_moments valid": (ops.int8_conv_moments, (x8, w8, "valid", 1),
                                    int8_mod.conv_moments_plain(x8, w8, "valid", 1)),
        "int8_conv_moments valid s2": (ops.int8_conv_moments, (x8, w8, "valid", 2),
                                       int8_mod.conv_moments_plain(x8, w8, "valid", 2)),
        "int8_norm_quant 3 count": (ops.int8_norm_quant, (3, hb, s, m, eps, None, torch.float32,
                                                          84),
                                    int8_mod.norm_relu_stream_quant_plain(hb, m, eps, s,
                                                                          torch.float32, 84)),
        "int8_norm_quant 1 count": (ops.int8_norm_quant, (1, hb, s, m, eps, None, None, 84),
                                    (None, int8_mod.norm_relu_quant_plain(hb, m, eps, s, 84))),
        "int8_norm_quant 0": (ops.int8_norm_quant, (0, stream, s, None, None, None, None),
                              (None, int8_mod.quantize_plain(stream, s))),
        "int8_norm_quant 1": (ops.int8_norm_quant, (1, hb, s, m, eps, None, None),
                              (None, int8_mod.norm_relu_quant_plain(hb, m, eps, s))),
        "int8_norm_quant 2": (ops.int8_norm_quant, (2, hb, s, m, eps, stream, None),
                              int8_mod.norm_skip_quant_plain(hb, m, eps, stream, s)),
        "int8_norm_quant 2 last": (ops.int8_norm_quant, (2, hb, None, m, eps, stream, None),
                                   int8_mod.norm_skip_quant_plain(hb, m, eps, stream, None)),
        "int8_norm_quant 3": (ops.int8_norm_quant, (3, hb, s, m, eps, None, torch.float32),
                              int8_mod.norm_relu_stream_quant_plain(hb, m, eps, s,
                                                                    torch.float32)),
    }


CASES = list(_cases())


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_every_kernel_is_an_operator():
    """The registry defines one operator a kernel entry point (A, B, B4, C,
    B5, D, E, B's split forward for the H-sharded tile, and the trunk
    backward's pad and its adjoint) and the transposed conv whose gradient
    B5 is; every case below exercises each."""
    assert sorted(_registry.OPERATORS) == sorted(
        ["trunk_conv", "instance_norm", "instance_norm_bwd", "head_conv", "convt_k3s2",
         "convt_k3s2_bwd", "int8_conv_moments", "int8_norm_quant", "instance_norm_sums",
         "instance_norm_apply", "reflect_pad", "reflect_pad_adjoint"])
    assert {name.split()[0] for name in CASES} == set(_registry.OPERATORS)


@pytest.mark.parametrize("name", CASES)
def test_operator_passes_opcheck_and_equals_its_plain_function(name):
    """``torch.library.opcheck`` (the schema, the autograd registration, the
    fake implementation against the real one, AOT dispatch), and on the CPU
    the operator's result is its plain function's, bit for bit."""
    op, args, want = _cases()[name]
    differentiable = name.split()[0] in ("trunk_conv", "instance_norm", "instance_norm_bwd",
                                         "head_conv", "convt_k3s2")
    if differentiable:
        args = tuple(a.clone().requires_grad_(True)
                     if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args)
    torch.library.opcheck(op, args)
    with torch.no_grad():
        got = op(*args)
    assert _equal(got, want), name


def test_operators_refuse_other_devices():
    """A tensor on a device with neither a kernel nor a plain route raises,
    through the fake implementation's dispatch rule: no fallback."""
    x = torch.zeros((1, 8, 8, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel and no plain route"):
        torch.ops.nirgan.instance_norm(x, None, 1e-5, False)
    with pytest.raises(RuntimeError, match="no kernel and no plain route"):
        torch.ops.nirgan.trunk_conv(x, torch.zeros((16, 16, 3, 3), device="meta"), None, 1)


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
def test_instance_norm_operator_gradgradcheck(relu):
    """The registered gradient of ``nirgan::instance_norm`` (through
    ``nirgan::instance_norm_bwd`` and its own registered gradient) against
    finite differences twice, f64, gradgradcheck's own tolerances."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 5, 4, 8), generator=g, dtype=torch.float64, requires_grad=True)
    r = torch.randn((2, 5, 4, 8), generator=g, dtype=torch.float64, requires_grad=True)

    def fn(x, r):
        return torch.ops.nirgan.instance_norm(x, r, 1e-5, relu)[0]

    assert torch.autograd.gradcheck(fn, (x, r))
    assert torch.autograd.gradgradcheck(fn, (x, r))


# ------------------------------------------------------------ the export
def _configure(cfg, inject: bool, quant: str = "none"):
    bc = cfg.base_configs
    bc.ngf, bc.ndf = 8, 8
    if not inject:
        bc.netG = "resnet_6blocks"
    else:
        cfg.satclip.satclip_path = None
    cfg.Data.padding_amount = 2
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.serving_quant = quant
    return cfg


def _config_path(inject):
    return os.path.join(REPO_ROOT, "configs",
                        "config_px2px_SatCLIP.yaml" if inject else "config_px2px.yaml")


@pytest.fixture(scope="module", params=["plain", "inject"])
def pair(request, tmp_path_factory):
    """The JAX task with its seeded params and artifact, and the port's task
    on the same weights with its artifact written to disk and read back."""
    inject = request.param == "inject"
    jt = JaxPx2PxTask(_configure(jax_load_config(_config_path(inject)), inject))
    state = jt.init_state(seed=0, image_size=SIZE)
    params = jax.device_get(state.params_g)
    task = Px2PxTask(_configure(load_config(_config_path(inject)), inject), device="cpu")
    task.bind(params_from_jax(params))
    path = tmp_path_factory.mktemp("export") / "generator.pt2"
    path.write_bytes(export_generator(task, task.netG.state_dict(), SIZE, BATCH))
    return jt, params, task, path.read_bytes()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.random((BATCH, 3, SIZE, SIZE)).astype(np.float32)
    return rgb, rng.standard_normal((BATCH, 256)).astype(np.float32)


def _live(task, rgb, embeds=None, trunk_q=None):
    with torch.no_grad():
        x = torch.from_numpy(rgb).permute(0, 2, 3, 1)
        e = torch.from_numpy(embeds) if embeds is not None and task.inject else None
        return task.g_apply(x, e, trunk_q).float().permute(0, 3, 1, 2)


def test_artifact_equals_jax_export(pair):
    """The port's artifact from bytes on disk against JAX's ``run_exported``
    of its own artifact (``tests/test_inference.py``'s round trip), the same
    weights and inputs, atol 2e-5 (JAX's own bound there); and against the
    port's live forward bit for bit."""
    jt, params, task, blob = pair
    rgb, embeds = _inputs()
    e = embeds if task.inject else None
    want = np.asarray(jax_run_exported(jax_export_generator(jt, params, SIZE, BATCH),
                                       params, rgb, e))
    got = run_exported(blob, task.netG.state_dict(), rgb, e)
    assert tuple(got.shape) == (BATCH, 1, SIZE, SIZE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert torch.equal(got, _live(task, rgb, embeds))


def test_artifact_serves_rotated_weights(pair):
    """A second seed's state_dict through the same artifact equals the live
    forward with those weights, bit for bit: the parameters are a runtime
    argument."""
    _, _, task, blob = pair
    other = Px2PxTask(task.config, device="cpu", seed=1)
    rgb, embeds = _inputs(1)
    exported = load_exported(blob)
    e = torch.from_numpy(embeds)
    first = exported.call(task.netG.state_dict(), torch.from_numpy(rgb), e)
    got = exported.call(other.netG.state_dict(), torch.from_numpy(rgb), e)
    assert torch.equal(got, _live(other, rgb, embeds))
    assert not torch.equal(got, first)


def test_exported_graph_holds_the_block_counts_operators(pair):
    """The exported graph calls A twice a residual block, B after each conv
    but the head (stem, two downsamples, two a block, two upsamples), C
    once, and the transposed conv twice."""
    _, _, task, blob = pair
    n = task.netG.n_blocks
    found = {}
    for node in load_exported(blob).program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("nirgan."):
            name = str(node.target).split(".")[1]
            found[name] = found.get(name, 0) + 1
    assert found == {"trunk_conv": 2 * n, "instance_norm": 2 * n + 5, "head_conv": 1,
                     "convt_k3s2": 2}


def test_artifact_refuses_another_device(pair):
    """An artifact runs on the device it was exported for: tensors elsewhere
    raise and say so, nothing is copied."""
    _, _, task, blob = pair
    exported = load_exported(blob)
    assert exported.device == torch.device("cpu")
    meta = torch.zeros((BATCH, 3, SIZE, SIZE), device="meta")
    with pytest.raises(ValueError, match="exported for cpu"):
        exported.call(task.netG.state_dict(), meta, torch.zeros((BATCH, 256)))


def test_call_hands_the_kernels_the_tensors_they_laid_out(pair):
    """A state_dict made anew for a call (``state_dict()`` detaches each
    parameter again) reaches the operators as the tensors of the first
    call, so kernel A's and C's kept layouts (``_pack.laid_out``, keyed by
    the tensor) hold; those tensors share the parameters' storage and
    version counter, so an in-place write makes the layout anew."""
    from nirgan_tpu_torch.ops import _pack

    _, _, task, blob = pair
    exported = load_exported(blob)
    first = exported._params(task.netG.state_dict())
    again = exported._params(task.netG.state_dict())
    assert all(again[k] is v for k, v in first.items())
    kept = again["netG.c1.weight"]
    layout = _pack.laid_out(kept, kept.device, kept.dtype, head_mod.taps_f32)
    assert _pack.laid_out(kept, kept.device, kept.dtype, head_mod.taps_f32) is layout
    with torch.no_grad():
        task.netG.c1.weight.mul_(2.0)
    after = exported._params(task.netG.state_dict())["netG.c1.weight"]
    relaid = _pack.laid_out(after, after.device, after.dtype, head_mod.taps_f32)
    assert relaid is not layout and torch.equal(relaid, 2.0 * layout)
    with torch.no_grad():
        task.netG.c1.weight.mul_(0.5)


def test_int8_artifact_equals_live_and_jax(tmp_path):
    """The int8 serving program with the pack as its fourth argument: equal
    to the port's live int8 forward within 1e-6, and to JAX's int8 artifact
    (each calibrating its own pack on the same input) >= 45 dB, the bound of
    ``tests/test_torch_int8.py`` for the int8 generator; the graph holds D
    twice a block and E twice a block and once more, and B only outside the
    trunk."""
    jt = JaxPx2PxTask(_configure(jax_load_config(_config_path(False)), False, "int8"))
    state = jt.init_state(seed=0, image_size=SIZE)
    params = jax.device_get(state.params_g)
    task = Px2PxTask(_configure(load_config(_config_path(False)), False, "int8"),
                     device="cpu")
    task.bind(params_from_jax(params))
    rgb, _ = _inputs(2)
    x = torch.from_numpy(rgb).permute(0, 2, 3, 1)
    pack = task.build_trunk_q(x)
    path = tmp_path / "int8.pt2"
    path.write_bytes(export_generator(task, task.netG.state_dict(), SIZE, BATCH,
                                      trunk_q=pack))
    got = run_exported(path.read_bytes(), task.netG.state_dict(), rgb, trunk_q=pack)
    np.testing.assert_allclose(got.numpy(), _live(task, rgb, trunk_q=pack).numpy(),
                               rtol=0, atol=1e-6)
    jq = jt.build_trunk_q(params, jnp.asarray(rgb.transpose(0, 2, 3, 1)))
    want = np.asarray(jax_run_exported(
        jax_export_generator(jt, params, SIZE, BATCH, trunk_q=jq), params, rgb, trunk_q=jq))
    mse = float(np.mean((got.numpy().astype(np.float64) - want) ** 2))
    assert 10 * np.log10(4.0 / mse) >= 45.0
    n = task.netG.n_blocks
    found = {}
    for node in load_exported(path.read_bytes()).program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("nirgan."):
            name = str(node.target).split(".")[1]
            found[name] = found.get(name, 0) + 1
    assert found == {"int8_conv_moments": 2 * n, "int8_norm_quant": 2 * n + 1,
                     "instance_norm": 5, "head_conv": 1, "convt_k3s2": 2}
    with pytest.raises(ValueError, match="int8 trunk pack"):
        run_exported(path.read_bytes(), task.netG.state_dict(), rgb)


LOADER = r"""
import json, sys
import numpy as np
import torch
from nirgan_tpu_torch.inference.export import run_exported
a = torch.load(sys.argv[2])
with open(sys.argv[1], "rb") as f:
    y = run_exported(f.read(), a["params"], a["rgb"], a["embeds"])
torch.save(y, sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "nirgan_tpu")
                        or m.startswith(("nirgan_tpu_torch.models", "nirgan_tpu_torch.tasks",
                                         "nirgan_tpu_torch.config")))))
"""


def test_artifact_loads_and_runs_without_model_code(pair, tmp_path):
    """A fresh process imports the export module (and through it
    ``nirgan_tpu_torch.ops``, which registers the operators), loads the
    artifact and runs it: the live forward's values, and neither jax,
    ``nirgan_tpu`` nor the port's models, tasks or config in
    ``sys.modules``."""
    _, _, task, blob = pair
    rgb, embeds = _inputs(3)
    (tmp_path / "g.pt2").write_bytes(blob)
    torch.save({"params": task.netG.state_dict(), "rgb": torch.from_numpy(rgb),
                "embeds": torch.from_numpy(embeds)}, tmp_path / "in.pt")
    env = {**os.environ, "PYTHONPATH": REPO_ROOT}
    res = subprocess.run([sys.executable, "-c", LOADER, str(tmp_path / "g.pt2"),
                          str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    assert torch.equal(torch.load(tmp_path / "out.pt"), _live(task, rgb, embeds))
