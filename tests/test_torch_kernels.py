"""The port's three kernel modules against the JAX Pallas kernels they
replace, on the CPU: each plain PyTorch version against the Pallas kernel
run as ``tests/test_pallas_kernels.py`` runs it (interpret mode), and the
dispatch rule (a CPU tensor takes the plain version and launches nothing;
the kernel wrappers refuse CPU tensors; other devices raise).  The CUDA
kernels themselves are checked on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nirgan_tpu.ops.conv import conv2d as jax_conv2d
from nirgan_tpu.ops.norm import instance_norm as jax_instance_norm
from nirgan_tpu.ops.pad import reflect_pad2d as jax_reflect_pad2d
from nirgan_tpu.ops.pallas_head import head_conv_pallas
from nirgan_tpu.ops.pallas_kernels import instance_norm_pallas
from nirgan_tpu.ops.pallas_trunk import conv3x3_pallas, conv3x3_reflect_pallas
from nirgan_tpu_torch.ops import head_conv as head_mod
from nirgan_tpu_torch.ops import instance_norm as in_mod
from nirgan_tpu_torch.ops import trunk_conv as trunk_mod
from nirgan_tpu_torch.ops.norm import instance_norm


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    for fn in (trunk_mod.trunk_conv_cuda, in_mod.instance_norm_cuda,
               head_mod.head_conv_cuda):
        fn.launches = 0
    yield


def _assert_no_launches():
    assert trunk_mod.trunk_conv_cuda.launches == 0
    assert in_mod.instance_norm_cuda.launches == 0
    assert head_mod.head_conv_cuda.launches == 0


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


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("call", [
    lambda x: trunk_mod.trunk_conv_cuda(x, torch.zeros(8, 8, 3, 3)),
    lambda x: in_mod.instance_norm_cuda(x),
    lambda x: head_mod.head_conv_cuda(x, torch.zeros(1, 8, 7, 7)),
], ids=["trunk_conv", "instance_norm", "head_conv"])
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
