"""The port's kernel modules against the JAX Pallas kernels they replace,
on the CPU: each plain PyTorch version against the Pallas kernel run as
``tests/test_pallas_kernels.py`` runs it (interpret mode), the dispatch rule
(a CPU tensor takes the plain version and launches nothing; the kernel
wrappers refuse CPU tensors; other devices raise), and the autograd wiring
of every op with a kernel.  The CUDA kernels themselves are checked on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nirgan_tpu.ops.conv import conv2d as jax_conv2d
from nirgan_tpu.ops.norm import instance_norm as jax_instance_norm
from nirgan_tpu.ops.pad import reflect_pad2d as jax_reflect_pad2d
from nirgan_tpu.ops.pallas_convt_bwd import convt_k3s2_bwd
from nirgan_tpu.ops.pallas_head import head_conv_pallas
from nirgan_tpu.ops.pallas_kernels import instance_norm_pallas
from nirgan_tpu.ops.pallas_trunk import conv3x3_pallas, conv3x3_reflect_pallas
from nirgan_tpu_torch.ops import _lib
from nirgan_tpu_torch.ops import convt_bwd as convt_mod
from nirgan_tpu_torch.ops import head_conv as head_mod
from nirgan_tpu_torch.ops import instance_norm as in_mod
from nirgan_tpu_torch.ops import trunk_conv as trunk_mod
from nirgan_tpu_torch.ops.instance_norm import instance_norm


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


KERNELS = (trunk_mod.trunk_conv_cuda, in_mod.instance_norm_cuda,
           in_mod.instance_norm_bwd_cuda, head_mod.head_conv_cuda,
           convt_mod.convt_k3s2_bwd_cuda)


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    for fn in KERNELS:
        fn.launches = 0
    yield


def _assert_no_launches():
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


# ------------------------------------------------------------ kernel A
def test_trunk_conv_matches_reflect_pallas():
    """pad=1 vs conv3x3_reflect_pallas, all four mirrored edges (the shape
    and atol of test_conv3x3_reflect_pallas_v2_interpret)."""
    rng = np.random.default_rng(7)
    B, H, W, WB, C = 2, 24, 21, 24, 8
    x = rng.standard_normal((B, H, WB, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(conv3x3_reflect_pallas(jnp.asarray(x), jnp.asarray(w),
                                                rh=8, wreal=W))[:, :, :W]
    got = trunk_mod.trunk_conv(torch.from_numpy(x[:, :, :W].copy()), _oihw(w),
                               torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), ref + bias, rtol=0, atol=1e-4)
    _assert_no_launches()


def test_trunk_conv_valid_matches_conv3x3_pallas():
    """pad=0 (VALID on a pre-padded input) vs conv3x3_pallas, which emits
    the 136 aligned columns of its output."""
    rng = np.random.default_rng(0)
    c = 16
    x = rng.standard_normal((2, 23, 144, c)).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, c, c))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), rh=7))
    got = trunk_mod.trunk_conv(torch.from_numpy(x), _oihw(w), pad=0)
    assert tuple(got.shape) == (2, 21, 142, c)
    np.testing.assert_allclose(got.numpy()[:, :, :136], ref, rtol=0, atol=1e-4)
    _assert_no_launches()


def test_trunk_conv_pad_modes_agree():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 9, 7, 16)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((32, 16, 3, 3))).astype(np.float32))
    from nirgan_tpu_torch.ops.pad import reflect_pad2d

    a = trunk_mod.trunk_conv(x, w, pad=1)
    b = trunk_mod.trunk_conv(reflect_pad2d(x, 1), w, pad=0)
    assert tuple(a.shape) == (1, 9, 7, 32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ kernel B
@pytest.mark.parametrize("shape,seed", [((2, 16, 16, 8), 0), ((1, 8, 8, 256), 1)])
def test_instance_norm_matches_pallas(shape, seed):
    """The plain version vs instance_norm_pallas (interpret mode on the CPU
    automatically) with the bounds of tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 1.5).astype(np.float32)
    ref = np.asarray(instance_norm_pallas(jnp.asarray(x)))
    got = instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    _assert_no_launches()


def test_instance_norm_bf16_matches_jax_formula():
    """bf16 in, bf16 out, against nirgan_tpu.ops.norm.instance_norm.  Both
    round mean, scale, x - mean and the product to bf16; f32 statistics
    summed in another order can round to the neighbouring bf16 value, which
    moves x - mean and y by a step each: |err| <= 2^-6 * (|y| + 1)."""
    rng = np.random.default_rng(4)
    x32 = (rng.standard_normal((2, 12, 10, 16)) * 3.0 + 1.5).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    ref = np.asarray(jax_instance_norm(xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = instance_norm(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= 2 ** -6 * (np.abs(ref) + 1))


def test_instance_norm_fused_relu_is_relu_of_norm():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 8)).astype(np.float32))
    torch.testing.assert_close(instance_norm(x, relu=True),
                               torch.relu(instance_norm(x)), rtol=0, atol=0)


# ------------------------------------------------------------ kernel C
def test_head_conv_matches_pallas():
    """tanh(conv + b) of the plain version vs head_conv_pallas (interpret
    mode) plus bias and tanh, at the shape and bound of
    test_pallas_head_conv_matches_conv2d."""
    rng = np.random.default_rng(0)
    shape = (2, 38, 46, 64)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.1 * rng.standard_normal((7, 7, 64, 1))).astype(np.float32)
    bias = np.float32(0.05)
    with pltpu.force_tpu_interpret_mode():
        conv = head_conv_pallas(jnp.asarray(x), jnp.asarray(k))
    ref = np.asarray(jnp.tanh(conv + bias))
    got = head_mod.head_conv(torch.from_numpy(x), _oihw(k),
                             torch.tensor([bias]))
    assert tuple(got.shape) == (2, 32, 40, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    _assert_no_launches()


def test_head_conv_plain_equals_reflect_head_of_jax():
    """head_conv(reflect_pad2d(h, 3)) is the JAX graph's head: reflect-pad
    3, the 7x7 conv with bias, tanh."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((1, 12, 10, 64)).astype(np.float32)
    k = (0.05 * rng.standard_normal((7, 7, 64, 1))).astype(np.float32)
    b = (0.1 * rng.standard_normal(1)).astype(np.float32)
    ref = np.asarray(jnp.tanh(jax_conv2d(jax_reflect_pad2d(jnp.asarray(h), 3),
                                         jnp.asarray(k), jnp.asarray(b))))
    from nirgan_tpu_torch.ops.pad import reflect_pad2d

    got = head_mod.head_conv(reflect_pad2d(torch.from_numpy(h), 3), _oihw(k),
                             torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ kernel B4
@pytest.mark.parametrize("shape,relu", [
    ((2, 12, 12, 4), False), ((2, 16, 16, 8), True), ((1, 8, 8, 256), False),
    ((1, 6, 5, 512), False), ((1, 6, 5, 512), True)])
def test_instance_norm_bwd_matches_pallas_vjp(shape, relu):
    """instance_norm_bwd_plain, fed the plain forward's statistics, vs
    jax.grad through instance_norm_pallas (its custom VJP runs _bwd_kernel
    in interpret mode on the CPU), ReLU fused or not; C = 512 is the
    PatchGAN's norm3.  The shapes of test_pallas_kernels.py, f32 atol 1e-5."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3.0 + 1.5).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)

    def loss(a):
        y = instance_norm_pallas(a)
        return jnp.sum((jnp.maximum(y, 0.0) if relu else y) * jnp.asarray(w))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    _, stats = in_mod.instance_norm_plain(xt, relu=relu, return_stats=True)
    assert tuple(stats.shape) == (shape[0], 2, shape[3])
    got = in_mod.instance_norm_bwd_plain(xt, torch.from_numpy(w), stats, relu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    _assert_no_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_relu_mask_from_x_equals_out_positive(dtype):
    """The backward takes the fused ReLU's mask from x and the statistics,
    rounded as the forward rounds; it must be ``out > 0`` bit for bit, also
    where x equals the rounded mean (the forward's value is then +0)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((2, 9, 7, 16)) * 3.0 + 1.5)
                         .astype(np.float32)).to(dtype)
    for _ in range(2):  # plant the rounded means, then once more on the new ones
        _, stats = in_mod.instance_norm_plain(x, relu=True, return_stats=True)
        x[:, 2, 3, :] = stats[:, 0, :].to(dtype)
        x[:, 5, 1, ::2] = stats[:, 0, ::2].to(dtype)
    out, stats = in_mod.instance_norm_plain(x, relu=True, return_stats=True)
    mask = in_mod._normalized(x, stats) > 0
    assert torch.equal(mask, out > 0)
    planted = x == stats[:, 0, None, None, :].to(dtype)
    assert not bool(mask[planted].any())
    if dtype == torch.bfloat16:  # the rounded mean outlives the planting
        assert int(planted.sum()) >= 16
    # and the backward built on it is the one built on the saved output
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)
    want = in_mod.instance_norm_bwd_plain(x, (g.float() * (out > 0)).to(dtype),
                                          stats, relu=False)
    got = in_mod.instance_norm_bwd_plain(x, g, stats, relu=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_residual_is_added_after_the_norm(dtype, relu):
    """``instance_norm(x, residual=r)`` is ``r + instance_norm(x)`` bit for
    bit: the two roundings of the block's ``x + norm(h)``."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 16)).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rng.standard_normal((2, 6, 5, 16)).astype(np.float32)).to(dtype)
    got = instance_norm(x, relu=relu, residual=r)
    assert got.dtype == dtype
    assert torch.equal(got, r + instance_norm(x, relu=relu))
    _assert_no_launches()


@pytest.mark.parametrize("route", ["plain", "kernel stand-ins"])
def test_instance_norm_residual_gradients_match_jax(route, monkeypatch):
    """Gradients of the block's ``x + norm(h)`` to x (the skip, passed on
    unchanged) and to h, vs ``jax.grad`` of the JAX formula, f32 atol 1e-5;
    on the CPU route and with the kernel wrappers stood in for."""
    rng = np.random.default_rng(13)
    shape = (2, 8, 6, 16)
    h = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)

    def loss(skip, a):
        return jnp.sum((skip + jax_instance_norm(a)) * jnp.asarray(w))

    ref_x, ref_h = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(h))
    if route != "plain":
        _kernel_standins(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    out = instance_norm(ht, residual=xt)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(ref_h), rtol=0, atol=1e-5)
    _assert_no_launches()


# the instance norm's shapes on the main path: the train step's six (G at
# 276^2, 138^2, 69^2; D at 64^2, 32^2, 31^2) and the serving forward's three
_KB = 1024
@pytest.mark.parametrize("b,hw,c,backward,regime", [
    (16, 69 * 69, 256, False, "resident"), (16, 69 * 69, 256, True, "resident"),
    (4, 133 * 133, 256, False, "resident"),
    (16, 138 * 138, 128, False, "resident"), (16, 138 * 138, 128, True, "streaming"),
    (16, 64 * 64, 128, False, "resident"), (16, 64 * 64, 128, True, "resident"),
    (16, 32 * 32, 256, False, "resident"), (16, 32 * 32, 256, True, "resident"),
    (16, 31 * 31, 512, False, "resident"), (16, 31 * 31, 512, True, "resident"),
    (16, 276 * 276, 64, False, "streaming"), (16, 276 * 276, 64, True, "streaming"),
    (4, 532 * 532, 64, False, "streaming"), (4, 266 * 266, 128, False, "streaming"),
])
def test_instance_norm_launch_plan_on_the_main_path(b, hw, c, backward, regime):
    """Every main-path shape lands in its regime, in bf16; a resident plan
    is a cluster of 1, 2, 4 or 8 blocks whose slab fits a block's shared
    memory in rows of at least 32 bytes; f32 doubles the bytes."""
    plan = in_mod.launch_plan(b, hw, c, 2, backward)
    assert plan.regime == regime and plan.cuda_launches == (1 if regime == "resident" else 2)
    assert plan.group * 2 >= 32 and c % plan.group == 0
    if regime == "resident":
        assert plan.cluster in (1, 2, 4, 8) and plan.slabs == plan.cluster
        assert plan.threads in (256, 512) and plan.group == 32
        rows = -(-hw // plan.cluster)
        slab = rows * plan.group * 2 * (2 if backward else 1)
        assert plan.smem_bytes == slab + in_mod._SCRATCH <= in_mod.MAX_SMEM == 232448
        # the cluster holds the whole slab
        assert plan.cluster * rows >= hw
        wide = in_mod.launch_plan(b, hw, c, 4, backward)
        if wide.regime == "resident":
            assert wide.smem_bytes - in_mod._SCRATCH == (
                -(-hw // wide.cluster) * wide.group * 4 * (2 if backward else 1))
            assert wide.cluster >= plan.cluster
    else:
        assert plan.cluster == 1 and plan.smem_bytes == 0 and plan.threads == 256
        assert 1 <= plan.slabs <= min(hw, 128)
        rows = -(-hw // plan.slabs)
        assert plan.slabs * rows >= hw > (plan.slabs - 1) * rows


@pytest.mark.parametrize("b,hw,c,itemsize,backward,want", [
    (2, 25, 8, 2, False, ("streaming", 8)),      # rows of 16 bytes: never resident
    (2, 25, 24, 2, True, ("streaming", 24)),
    (2, 25, 520, 2, False, ("streaming", 256)),
    (2, 25, 520, 4, False, ("streaming", 128)),
    (1, 1, 64, 2, False, ("resident", 32)),      # one pixel
    (1, 1, 8, 4, True, ("streaming", 8)),
    (3, 7, 96, 2, True, ("resident", 32)),       # C % 64 != 0
    (1, 3, 64, 4, True, ("resident", 32)),
    (16, 69 * 69, 256, 4, False, ("resident", 32)),
    (16, 69 * 69, 256, 4, True, ("resident", 32)),
    (4, 133 * 133, 256, 4, False, ("streaming", 128)),
])
def test_instance_norm_launch_plan_odd_shapes(b, hw, c, itemsize, backward, want):
    plan = in_mod.launch_plan(b, hw, c, itemsize, backward)
    assert (plan.regime, plan.group) == want
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= hw
    assert plan.smem_bytes <= in_mod.MAX_SMEM and 1 <= plan.slabs <= hw
    if plan.regime == "resident":
        assert plan.group * itemsize >= 32 and c % plan.group == 0
    else:
        assert plan.group * itemsize <= 512 and plan.group % (16 // itemsize) == 0


def test_instance_norm_plan_constants_match_the_source():
    """The plan's constants are the kernel's own: the resident channel
    group, the scratch ahead of the slab, a block's shared memory, the
    copy groups in flight; and only the private launchers take a plan."""
    import inspect
    import pathlib
    import re

    src = (pathlib.Path(in_mod.__file__).parent.parent / "csrc"
           / "instance_norm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("GROUP") == in_mod._GROUP
    assert (2 * (const("MAX_THREADS") // 32) + 4) * const("GROUP") * 4 == in_mod._SCRATCH
    assert const("MAX_SMEM") == in_mod.MAX_SMEM
    assert const("STAGES") == in_mod._STAGES
    for fn in (in_mod.instance_norm_cuda, in_mod.instance_norm_bwd_cuda):
        assert "plan" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("b,hw,c", [(0, 4, 8), (1, 0, 8), (1, 4, 12), (1, 4, 0)])
def test_instance_norm_launch_plan_refuses(b, hw, c):
    with pytest.raises(ValueError, match="no plan"):
        in_mod.launch_plan(b, hw, c, 2, False)


def test_instance_norm_forward_matches_pallas_at_c512():
    """The forward at C = 512 (the PatchGAN's norm3, a 128-filter
    trunk) vs instance_norm_pallas."""
    x = (np.random.default_rng(9).standard_normal((2, 5, 7, 512)) * 3.0
         + 1.5).astype(np.float32)
    ref = np.asarray(instance_norm_pallas(jnp.asarray(x)))
    got = instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    _assert_no_launches()


# ------------------------------------------------------------ kernel B5
@pytest.mark.parametrize("b,hi,wi,ci,co", [
    (2, 12, 12, 128, 64), (1, 24, 16, 128, 64), (2, 14, 10, 256, 128)])
def test_convt_bwd_matches_pallas(b, hi, wi, ci, co):
    """convt_k3s2_bwd_plain vs convt_k3s2_bwd in interpret mode, at the
    shapes and bounds of test_convt_bwd_pallas_matches_vjp (dx atol 2e-4,
    dW atol 2e-3).  The JAX kernel is (3, 3, Ci, Co); the port's weight is
    torch's (Ci, Co, 3, 3) of the same numbers."""
    rng = np.random.default_rng(ci + hi)
    z = rng.random((b, hi, wi, ci)).astype(np.float32)
    w = (0.1 * rng.random((3, 3, ci, co))).astype(np.float32)
    ct = rng.random((b, 2 * hi, 2 * wi, co)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        dz_ref, dw_ref = convt_k3s2_bwd(jnp.asarray(ct), jnp.asarray(z),
                                        jnp.asarray(w))
    dz, dw = convt_mod.convt_k3s2_bwd_plain(
        torch.from_numpy(ct), torch.from_numpy(z),
        torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1))))
    assert dw.dtype == torch.float32 and tuple(dz.shape) == z.shape
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_ref), rtol=0, atol=2e-4)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 0, 1),
                               np.asarray(dw_ref), rtol=0, atol=2e-3)
    _assert_no_launches()


def test_convt_bwd_plain_needs_select_the_gradients():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.random((1, 4, 3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((8, 16, 3, 3)).astype(np.float32))
    ct = torch.from_numpy(rng.random((1, 8, 6, 16)).astype(np.float32))
    both = convt_mod.convt_k3s2_bwd_plain(ct, z, w)
    dx, dw = convt_mod.convt_k3s2_bwd_plain(ct, z, w, (True, False))
    assert dw is None and torch.equal(dx, both[0])
    dx, dw = convt_mod.convt_k3s2_bwd_plain(ct, z, w, (False, True))
    assert dx is None and torch.equal(dw, both[1])


# ------------------------------------------------------------ autograd wiring
def _kernel_standins(monkeypatch):
    """Make every CPU tensor take the kernel route, with each kernel
    wrapper replaced by its plain version run as a kernel runs: outside
    autograd, so its output carries no graph of its own."""
    def as_kernel(fn):
        def launch(*args, **kwargs):
            with torch.no_grad():
                return fn(*args, **kwargs)
        return launch

    monkeypatch.setattr(_lib, "route", lambda x, name: True)
    for mod, name, plain in (
            (trunk_mod, "trunk_conv_cuda", trunk_mod.trunk_conv_plain),
            (in_mod, "instance_norm_cuda", in_mod.instance_norm_plain),
            (in_mod, "instance_norm_bwd_cuda", in_mod.instance_norm_bwd_plain),
            (head_mod, "head_conv_cuda", head_mod.head_conv_plain),
            (convt_mod, "convt_k3s2_bwd_cuda", convt_mod.convt_k3s2_bwd_plain)):
        monkeypatch.setattr(mod, name, as_kernel(plain))


def _plain_autograd(monkeypatch):
    """Route the models around the autograd Functions: the plain versions,
    differentiated by torch's own autograd."""
    import torch.nn.functional as F

    from nirgan_tpu_torch.models import generator, layers

    def convt(x, weight, bias=None, stride=2, padding=1, output_padding=1):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=stride,
                               padding=padding, output_padding=output_padding)
        return y.permute(0, 2, 3, 1) + bias

    monkeypatch.setattr(generator, "trunk_conv", trunk_mod.trunk_conv_plain)
    monkeypatch.setattr(generator, "head_conv", head_mod.head_conv_plain)
    monkeypatch.setattr(layers, "instance_norm", in_mod.instance_norm_plain)
    monkeypatch.setattr(layers, "conv_transpose2d", convt)


def _gan_grads(G, D, x, target):
    """Gradients of a small GAN objective through G and D: L1 of G's
    output plus the lsgan term of D on it."""
    for p in (*G.parameters(), *D.parameters()):
        p.grad = None
    pred = G(x)
    logits = D(torch.cat([x, pred], dim=-1))
    loss = torch.mean((logits - 1.0) ** 2) + torch.mean(torch.abs(pred - target))
    loss.backward()
    return {f"{tag}.{k}": p.grad for tag, net in (("G", G), ("D", D))
            for k, p in net.named_parameters()}


def _ahead_of_a_norm(key):
    """A conv bias whose output feeds an instance norm, which removes it:
    every G bias but the head's, D's between its first and last conv."""
    if key.startswith("G."):
        return key.endswith(".bias") and key != "G.c1.bias"
    return key in ("D.conv1.bias", "D.conv2.bias", "D.conv3.bias")


def test_kernel_route_keeps_the_graph(monkeypatch):
    """On the kernel route every op is an autograd Function, so a
    kernel's output is differentiable.  With stand-ins that compute as the
    kernels do (no graph of their own), a small generator and
    discriminator get exactly the gradients of plain autograd, and every
    parameter gets one."""
    from nirgan_tpu_torch.models import define_D, define_G

    torch.manual_seed(0)
    G = define_G(3, 1, 8, "resnet_6blocks", "instance",
                 generator=torch.Generator().manual_seed(1))
    D = define_D(4, 8, "basic", norm="instance",
                 generator=torch.Generator().manual_seed(2))
    x = torch.rand((2, 24, 24, 3))
    target = torch.rand((2, 24, 24, 1))
    with monkeypatch.context() as m:
        _plain_autograd(m)
        ref = _gan_grads(G, D, x, target)
    with monkeypatch.context() as m:
        _kernel_standins(m)
        got = _gan_grads(G, D, x, target)
    assert set(got) == set(ref)
    net_max = {tag: max(float(g.abs().max()) for k, g in ref.items()
                        if k.startswith(tag)) for tag in ("G.", "D.")}
    for k, g in got.items():
        assert g is not None, f"{k} got no gradient on the kernel route"
        err = float((g - ref[k]).abs().max())
        if _ahead_of_a_norm(k):
            # zero in exact arithmetic, f32 noise on both sides: below 1e-5
            # of the network's largest gradient
            assert float(ref[k].abs().max()) <= 1e-5 * net_max[k[:2]], k
            assert err <= 1e-5 * net_max[k[:2]], (k, err)
        else:
            scale = float(ref[k].abs().max())
            assert err <= 1e-4 * scale, (k, err, scale)


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("call", [
    lambda x: trunk_mod.trunk_conv_cuda(x, torch.zeros(8, 8, 3, 3)),
    lambda x: in_mod.instance_norm_cuda(x),
    lambda x: in_mod.instance_norm_bwd_cuda(x, x, torch.zeros(1, 2, 8)),
    lambda x: head_mod.head_conv_cuda(x, torch.zeros(1, 8, 7, 7)),
    lambda x: convt_mod.convt_k3s2_bwd_cuda(torch.zeros(1, 16, 16, 8), x,
                                            torch.zeros(8, 8, 3, 3)),
], ids=["trunk_conv", "instance_norm", "instance_norm_bwd", "head_conv",
        "convt_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros(1, 8, 8, 8))
    _assert_no_launches()


@pytest.mark.parametrize("call", [
    lambda x: trunk_mod.trunk_conv(x, torch.zeros(8, 8, 3, 3, device="meta")),
    lambda x: instance_norm(x),
    lambda x: head_mod.head_conv(x, torch.zeros(1, 8, 7, 7, device="meta")),
], ids=["trunk_conv", "instance_norm", "head_conv"])
def test_other_devices_raise(call):
    with pytest.raises(RuntimeError, match="no kernel and no plain route"):
        call(torch.zeros(1, 8, 8, 8, device="meta"))


# ------------------------------------------------- what Python does for wgmma
from nirgan_tpu_torch.ops import _pack  # noqa: E402


def _b128_offset(t, n, k, n_rows, k_total):
    """Element offset of w[t, n, k] in the packed buffer by the swizzle
    formula: image (t, k // 64) of ``n_rows`` rows of 64, row n, 16-byte
    chunk ((k % 64) // 8) ^ (n % 8), element k % 8."""
    image = t * (k_total // 64) + k // 64
    chunk = ((k % 64) // 8) ^ (n % 8)
    return (image * n_rows + n) * 64 + chunk * 8 + k % 8


def _unpack_b128(p):
    """(T, K // 64, N, 8, 8) -> (T, N, K): the swizzle undone by the
    formula, without the module's index."""
    t, s, n = p.shape[:3]
    rows = torch.arange(n)[:, None]
    chunks = torch.arange(8)[None, :] ^ (rows & 7)
    return p[:, :, rows, chunks, :].permute(0, 2, 1, 3, 4).reshape(t, n, s * 64)


@pytest.mark.parametrize("t,n,k", [(1, 8, 64), (9, 256, 128), (9, 128, 64),
                                   (2, 24, 192)])
def test_pack_b128_inverts_and_follows_the_swizzle_formula(t, n, k):
    """Every element (tap, n, k) lies at the offset the 128-byte swizzle
    gives: image (tap, k // 64) of n rows of 128 bytes, 16-byte chunk
    ((k % 64) // 8) ^ (n % 8); unpacking gives the input back exactly."""
    w = torch.arange(t * n * k, dtype=torch.float32).reshape(t, n, k)
    packed = _pack.pack_b128(w)
    assert packed.shape == (t, k // 64, n, 8, 8) and packed.is_contiguous()
    assert torch.equal(_unpack_b128(packed), w)
    tt, nn, kk = torch.meshgrid(torch.arange(t), torch.arange(n), torch.arange(k),
                                indexing="ij")
    assert torch.equal(packed.flatten()[_b128_offset(tt, nn, kk, n, k)], w)


def test_pack_b128_takes_strided_views_and_refuses_ragged_shapes():
    w = torch.randn(9, 16, 128).permute(0, 2, 1)[:, :64].permute(0, 2, 1)
    assert not w.is_contiguous()
    assert torch.equal(_pack.pack_b128(w), _pack.pack_b128(w.contiguous()))
    for bad in (torch.zeros(1, 8, 32), torch.zeros(1, 4, 64)):
        with pytest.raises(ValueError, match="pack_b128"):
            _pack.pack_b128(bad)


def test_trunk_conv_packs_element_tap_ci_co_where_the_kernel_reads_it():
    """Kernel A's B image for (tap, 64-channel slice): row co, K = ci."""
    w = torch.randn(256, 128, 3, 3)
    packed = trunk_mod.pack_weight(w)
    assert packed.shape == (9, 2, 256, 8, 8)
    flat = packed.flatten()
    for co, ci, ky, kx in ((0, 0, 0, 0), (255, 127, 2, 2), (77, 70, 1, 2)):
        assert flat[_b128_offset(ky * 3 + kx, co, ci, 256, 128)] == w[co, ci, ky, kx]
    back = _unpack_b128(packed).reshape(3, 3, 256, 128).permute(2, 3, 0, 1)
    assert torch.equal(back, w)


def test_convt_bwd_packs_element_tap_co_ci_where_the_kernel_reads_it():
    """B5's dx image for (tap, 64-channel slice of Co): row ci, K = co."""
    w = torch.randn(128, 64, 3, 3)
    packed = convt_mod.pack_weight(w)
    assert packed.shape == (9, 1, 128, 8, 8)
    flat = packed.flatten()
    for ci, co, ky, kx in ((0, 0, 0, 0), (127, 63, 2, 2), (9, 40, 2, 0)):
        assert flat[_b128_offset(ky * 3 + kx, ci, co, 128, 64)] == w[ci, co, ky, kx]


def _counting(layout):
    calls = []

    def counted(w):
        calls.append(1)
        return layout(w)
    return counted, calls


@pytest.mark.parametrize("write", ["none", "optimizer", "copy_", "load_state_dict"])
def test_laid_out_packs_once_until_the_weight_is_written(write):
    """The kept layout is reused while the weight keeps its value and made
    anew, from the new value, after any in-place write."""
    conv = torch.nn.Conv2d(64, 256, 3)
    w = conv.weight
    pack, calls = _counting(trunk_mod.pack_weight)
    cpu = torch.device("cpu")
    first = _pack.laid_out(w, cpu, torch.bfloat16, pack)
    assert _pack.laid_out(w, cpu, torch.bfloat16, pack) is first and len(calls) == 1
    assert first.dtype == torch.bfloat16 and not first.requires_grad
    assert torch.equal(first, trunk_mod.pack_weight(w.detach().bfloat16()))
    if write == "optimizer":
        w.grad = torch.ones_like(w)
        torch.optim.Adam([w], lr=0.1).step()
    elif write == "copy_":
        with torch.no_grad():
            w.copy_(torch.randn_like(w))
    elif write == "load_state_dict":
        conv.load_state_dict(torch.nn.Conv2d(64, 256, 3).state_dict())
    again = _pack.laid_out(w, cpu, torch.bfloat16, pack)
    if write == "none":
        assert again is first and len(calls) == 1
    else:
        assert len(calls) == 2 and not torch.equal(again, first)
        assert torch.equal(again, trunk_mod.pack_weight(w.detach().bfloat16()))


def test_laid_out_keys_on_dtype_and_layout_and_forgets_dead_weights():
    w = torch.randn(256, 64, 3, 3)
    cpu = torch.device("cpu")
    a = _pack.laid_out(w, cpu, torch.bfloat16, trunk_mod.pack_weight)
    b = _pack.laid_out(w, cpu, torch.float32, _pack.taps_first)
    assert b.dtype == torch.float32 and b.shape == (3, 3, 64, 256)
    assert torch.equal(_pack.laid_out(w, cpu, torch.bfloat16, trunk_mod.pack_weight), a)
    ident = id(w)
    assert ident in _pack._LAID_OUT
    del w
    assert ident not in _pack._LAID_OUT
    # a tensor made in inference mode has no version counter: never kept
    with torch.inference_mode():
        v = torch.randn(256, 64, 3, 3)
        _pack.laid_out(v, cpu, torch.bfloat16, trunk_mod.pack_weight)
    assert id(v) not in _pack._LAID_OUT


@pytest.mark.parametrize("dtype,x_shape,w_shape,pad,want", [
    (torch.bfloat16, (4, 133, 133, 256), (256, 256, 3, 3), 1, (133, 133, True)),
    (torch.bfloat16, (16, 71, 71, 256), (256, 256, 3, 3), 0, (69, 69, True)),
    (torch.bfloat16, (2, 9, 9, 64), (256, 64, 3, 3), 1, (9, 9, True)),
    (torch.bfloat16, (2, 9, 9, 32), (256, 32, 3, 3), 1, (9, 9, False)),
    (torch.bfloat16, (2, 9, 9, 128), (128, 128, 3, 3), 1, (9, 9, False)),
    (torch.float32, (2, 9, 9, 256), (256, 256, 3, 3), 1, (9, 9, False)),
    (torch.float32, (2, 9, 9, 16), (64, 16, 3, 3), 0, (7, 7, False)),
])
def test_trunk_conv_launch_plan_chooses_by_shape(dtype, x_shape, w_shape, pad, want):
    assert trunk_mod.launch_plan(dtype, x_shape, w_shape, pad) == want


@pytest.mark.parametrize("dtype,x_shape,w_shape,pad,message", [
    (torch.bfloat16, (2, 9, 9, 16), (128, 16, 3, 3), 1, "Cin % 32"),
    (torch.bfloat16, (2, 9, 9, 64), (64, 64, 3, 3), 1, "Cout % 128"),
    (torch.float32, (2, 9, 9, 8), (64, 8, 3, 3), 1, "Cin % 16"),
    (torch.float16, (2, 9, 9, 64), (256, 64, 3, 3), 1, "not supported"),
    (torch.bfloat16, (2, 9, 9, 64), (256, 32, 3, 3), 1, "is not"),
    (torch.bfloat16, (2, 9, 9, 64), (256, 64, 3, 3), 2, "pad must be"),
    (torch.bfloat16, (2, 1, 9, 64), (256, 64, 3, 3), 1, "H, W >= 2"),
    (torch.bfloat16, (2, 2, 9, 64), (256, 64, 3, 3), 0, "H, W >= 3"),
    (torch.bfloat16, (9, 9, 64), (256, 64, 3, 3), 1, r"\(B, H, W, C\)"),
    (torch.bfloat16, (2 ** 11, 2 ** 10, 2 ** 10, 64), (256, 64, 3, 3), 1, "2\\^31"),
])
def test_trunk_conv_launch_plan_raises_on_what_no_kernel_takes(dtype, x_shape, w_shape,
                                                              pad, message):
    with pytest.raises(ValueError, match=message):
        trunk_mod.launch_plan(dtype, x_shape, w_shape, pad)


@pytest.mark.parametrize("dtype,b,h,ci,co,want", [
    (torch.bfloat16, 16, 138, 128, 64, (True, 44, 6976)),    # u1: 3 groups
    (torch.bfloat16, 16, 69, 256, 128, (True, 11, 6976)),    # u0: 12 groups
    (torch.bfloat16, 1, 4, 128, 64, (True, 1, 64)),
    (torch.bfloat16, 2, 20, 64, 32, (False, 80, 10)),        # WMMA
    (torch.bfloat16, 2, 20, 128, 32, (False, 80, 10)),
    (torch.float32, 16, 138, 128, 64, (False, 15, 20314)),   # SIMT
])
def test_convt_bwd_launch_plan_chooses_by_shape(dtype, b, h, ci, co, want):
    got = convt_mod.launch_plan(dtype, (b, h, h, ci), (b, 2 * h, 2 * h, co),
                                (ci, co, 3, 3))
    assert got == want
    packed, s, slab = got
    m = b * h * h
    # the slabs cover the pixels and none is empty
    assert s * slab >= m > (s - 1) * slab
    if packed:
        assert slab % 64 == 0 and 3 * (co // 64) * (ci // 128) * s <= 132


@pytest.mark.parametrize("dtype,z_shape,ct_shape,w_shape,message", [
    (torch.bfloat16, (2, 8, 8, 12), (2, 16, 16, 8), (12, 8, 3, 3), "multiples of 8"),
    (torch.bfloat16, (2, 8, 8, 16), (2, 16, 15, 8), (16, 8, 3, 3), "2H, 2W"),
    (torch.bfloat16, (2, 8, 8, 16), (2, 16, 16, 8), (8, 16, 3, 3), "weight"),
    (torch.float16, (2, 8, 8, 16), (2, 16, 16, 8), (16, 8, 3, 3), "not supported"),
    (torch.bfloat16, (0, 8, 8, 16), (0, 16, 16, 8), (16, 8, 3, 3), "input pixels"),
])
def test_convt_bwd_launch_plan_raises_on_what_no_kernel_takes(dtype, z_shape, ct_shape,
                                                             w_shape, message):
    with pytest.raises(ValueError, match=message):
        convt_mod.launch_plan(dtype, z_shape, ct_shape, w_shape)


def test_kernel_sources_and_headers_exist_and_key_the_build():
    """Every listed source and header is in ``csrc``; editing a header
    changes the library's name, so a stale build is never loaded."""
    for name in _lib.SOURCES + _lib.HEADERS:
        assert (_lib.CSRC / name).is_file(), name
    listed = set(_lib.SOURCES + _lib.HEADERS)
    on_disk = {p.name for p in _lib.CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h")}
    assert on_disk == listed


# ------------------------------------------- what Python does for the head's mma
def _pallas_wblk():
    from nirgan_tpu.ops.pallas_head import _build_wblk

    return _build_wblk


@pytest.mark.parametrize("shape", [(2, 12, 30, 64), (1, 7, 22, 64), (1, 9, 14, 16)])
def test_head_toeplitz_image_is_the_conv(shape):
    """An einsum of the Toeplitz image with the gathered windows (7 input
    rows, 14 pixels of all channels flattened to K) equals ``F.conv2d`` for
    every group of 8 output columns: f32, 1e-5 of the largest output."""
    rng = np.random.default_rng(0)
    b, hp, wp, c = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, c, 7, 7)).astype(np.float32)) / (7 * c ** 0.5)
    image = _pack.head_toeplitz(w[0].permute(1, 2, 0))
    assert image.shape == (7, 14 * c, 8)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w)[:, 0]
    ho, wo = hp - 6, wp - 6
    assert wo % 8 == 0
    got = torch.empty_like(ref)
    for x0 in range(0, wo, 8):
        windows = torch.stack([x[:, dy:dy + ho, x0:x0 + 14].reshape(b, ho, 14 * c)
                               for dy in range(7)])
        got[:, :, x0:x0 + 8] = torch.einsum("dbyk,dkp->byp", windows, image)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_head_toeplitz_taps_are_those_of_build_wblk():
    """Row dy of the image holds, for pixel j and column p, the tap
    w[dy, j - p] where 0 <= j - p < 7 and zero elsewhere: the TPU kernel's
    ``_build_wblk`` at its row-parity 0 and the same 8 column parities."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((7, 7, 64, 1)).astype(np.float32)
    image = _pack.head_toeplitz(torch.from_numpy(k[..., 0])).reshape(7, 14, 64, 8)
    wblk = np.asarray(_pallas_wblk()(jnp.asarray(k), 64)).reshape(14, 16, 64, 8, 8)
    # wblk[jy, jx, c, py, px] = w[jy - py, jx - px, c]: py = 0 gives dy = jy
    np.testing.assert_array_equal(image.numpy(), wblk[:7, :14, :, 0, :])
    assert not wblk[:7, 14:, :, 0, :].any()
    for dy, j, p in ((0, 0, 0), (3, 9, 4), (6, 13, 7)):
        np.testing.assert_array_equal(image[dy, j, :, p].numpy(), k[dy, j - p, :, 0])
    assert not image[:, 0, :, 1:].any() and not image[:, 13, :, :7].any()


def test_mma_b_fragments_follow_the_register_order():
    """Lane l of fragment (t, kc) holds column l // 4 at k = 16 kc + 2 (l %
    4) + (0, 1, 8, 9); the permutation loses nothing."""
    t = torch.arange(3 * 32 * 8, dtype=torch.float32).reshape(3, 32, 8)
    frag = _pack.mma_b_fragments(t)
    assert frag.shape == (3, 2, 32, 4) and frag.is_contiguous()
    for lane in range(32):
        for kc in range(2):
            ks = [16 * kc + 2 * (lane % 4) + o for o in (0, 1, 8, 9)]
            assert torch.equal(frag[1, kc, lane], t[1, ks, lane // 4])
    assert sorted(frag.flatten().tolist()) == t.flatten().tolist()
    with pytest.raises(ValueError, match="multiple of 16"):
        _pack.mma_b_fragments(torch.zeros(1, 24, 8))
    with pytest.raises(ValueError, match="must be 8"):
        _pack.mma_b_fragments(torch.zeros(1, 16, 4))


def test_head_conv_packs_the_weight_where_the_kernel_reads_it():
    """``pack_weight`` is the fragment order of the Toeplitz image of the
    (ky, kx, C) taps: 7 x 56 fragments of 32 lanes x 4 bf16, 100 KB; the f32
    kernel's layout is the taps themselves."""
    w = torch.randn(1, 64, 7, 7).bfloat16()
    packed = head_mod.pack_weight(w)
    assert packed.shape == (7, 56, 32, 4) and packed.dtype == torch.bfloat16
    assert packed.numel() * 2 == 100352
    image = _pack.head_toeplitz(w[0].permute(1, 2, 0))
    # warp 2's chunk 3 (kc = 17: pixel 4, channels 16..31), weight row 5,
    # lane 13 (column 3, q = 1): k = 2, 3, 10, 11 of the chunk
    assert torch.equal(packed[5, 17, 13], image[5, [274, 275, 282, 283], 3])
    assert torch.equal(image[5, 274, 3], w[0, 18, 5, 1])
    taps = head_mod.taps_f32(w)
    assert taps.dtype == torch.float32 and taps.shape == (7, 7, 64)
    assert torch.equal(taps[2, 4], w[0, :, 2, 4].float())
    assert head_mod.takes_mma(torch.bfloat16) and not head_mod.takes_mma(torch.float32)


@pytest.mark.parametrize("b,ho,wo,rows,blocks", [
    (16, 276, 276, 46, 240),   # the train step's head
    (4, 532, 532, 38, 252),    # the serving forward's
    (8, 276, 276, 46, 120),    # the SatCLIP config's batch
    (1, 1, 3, 1, 1),           # the smallest input
    (2, 64, 64, 8, 8),
])
def test_head_conv_launch_plan(b, ho, wo, rows, blocks):
    """The rows of a run at the main path's shapes on a 132-SM card, and
    the grid that follows: B x strips of 64 columns x pairs of runs, every
    output row in exactly one run."""
    got = head_mod.launch_plan(b, ho, wo, 132)
    assert got == rows
    pairs = -(-ho // (2 * got))
    assert b * -(-wo // head_mod.STRIP) * pairs == blocks
    assert 2 * got * pairs >= ho > 2 * got * (pairs - 1)


def test_head_conv_keeps_its_layout_until_the_weight_is_written():
    """The head's layouts go through ``laid_out``: packed once for each
    dtype, again after an optimizer's write."""
    conv = torch.nn.Conv2d(64, 1, 7)
    w, cpu = conv.weight, torch.device("cpu")
    a = _pack.laid_out(w, cpu, torch.bfloat16, head_mod.pack_weight)
    assert _pack.laid_out(w, cpu, torch.bfloat16, head_mod.pack_weight) is a
    f = _pack.laid_out(w, cpu, torch.float32, head_mod.taps_f32)
    assert f.shape == (7, 7, 64) and f.dtype == torch.float32
    w.grad = torch.ones_like(w)
    torch.optim.SGD([w], lr=0.5).step()
    again = _pack.laid_out(w, cpu, torch.bfloat16, head_mod.pack_weight)
    assert again is not a and not torch.equal(again, a)
    assert torch.equal(again, head_mod.pack_weight(w.detach().bfloat16()))
