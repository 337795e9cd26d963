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
    y, stats = in_mod.instance_norm_plain(xt, relu=relu, return_stats=True)
    assert tuple(stats.shape) == (shape[0], 2, shape[3])
    got = in_mod.instance_norm_bwd_plain(xt, torch.from_numpy(w), stats,
                                         y if relu else None)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    _assert_no_launches()


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
