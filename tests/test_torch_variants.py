"""The port's model variants against the JAX package, on the CPU in f32 at
a small size (ngf 8, ndf 8, batch 2): the U-Net generators (unet_128 at
128^2, unet_256 at 256^2), batch norm with running statistics (flax's rule,
not torch's), dropout under one shared keep-mask, the pixel discriminator,
the replicate and zero trunks, ``gradient_penalty``, the init types, the
fused step with each variant, and a resume that repeats a run bit for bit.
Also: the kernel operators refuse a double backward, and the replicate
pad's fixed-order adjoint equals ``F.pad``'s autograd."""

import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.losses.gan import gradient_penalty as jax_gradient_penalty
from nirgan_tpu.models.factory import define_D as jax_define_D
from nirgan_tpu.models.factory import define_G as jax_define_G
from nirgan_tpu.models.generator import ResnetGenerator as JaxResnetGenerator
from nirgan_tpu.ops import initializers as jax_inits
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu.train.state import create_state
from nirgan_tpu_torch.losses import gan as port_gan
from nirgan_tpu_torch.losses import gradient_penalty
from nirgan_tpu_torch.models import ResnetGenerator, define_D, define_G, layers
from nirgan_tpu_torch.models.layers import Norm
from nirgan_tpu_torch.ops import initializers as port_inits
from nirgan_tpu_torch.ops.conv import conv_transpose2d
from nirgan_tpu_torch.ops.head_conv import head_conv
from nirgan_tpu_torch.ops.instance_norm import instance_norm
from nirgan_tpu_torch.ops.pad import replicate_pad2d, replicate_pad2d_adjoint
from nirgan_tpu_torch.ops.trunk_conv import trunk_conv
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.weights import d_params_from_jax, params_from_jax
from tests.conftest import REPO_ROOT
from tests.test_torch_train import _ahead_of_a_norm, _assert_grads_close

# the cross-stack bound of tests/test_torch_generator.py
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs six workers on the CPU at once; torch's intra-op pool
    on every core in each of them makes these small ops wait on one another
    (tests/test_torch_scene.py measured it), so one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.device_get(tree)


def _fill(shapes, seed=0):
    """Seeded numpy values for a tree of ``jax.eval_shape`` leaves, by leaf
    name: conv kernels N(0, 0.02), biases N(0, 0.02) (not zero, so that
    they are held too), batch-norm scales N(1, 0.1), running means N(0,
    0.1) and variances 1 + |N(0, 0.3)|.  Tracing the init instead of
    running it keeps the tests clear of its compile."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "mean":
            return 0.1 * z
        if name == "var":
            return 1.0 + np.abs(0.3 * z)
        return 0.02 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_net(net, x_shape, seed=0):
    """(module, numpy variables) of a JAX network with seeded weights."""
    return net, _fill(jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                                      jnp.zeros(x_shape))), seed)


def _apply(net, variables, x, **kw):
    """``net.apply`` under ``jax.jit``, numpy out."""
    return _np(jax.jit(lambda v, x: net.apply(v, x, **kw))(variables, jnp.asarray(x)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ------------------------------------------------------------ forwards
@pytest.mark.parametrize("netG,size", [("unet_128", 128), ("unet_256", 256)])
@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_unet_forward_matches_jax(netG, size, norm):
    """The U-Net's eval forward, weights carried by ``params_from_jax`` into
    the port's nested names with ``strict=True``."""
    g, v = _jax_net(jax_define_G(3, 1, 8, netG, norm=norm, compute_dtype=jnp.float32),
                    (1, size, size, 3))
    port = define_G(3, 1, 8, netG, norm)
    port.load_state_dict(params_from_jax(v["params"], v.get("batch_stats")),
                         strict=True)
    x = _x((2, size, size, 3))
    ref = _apply(g, v, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_unet_names_follow_the_jax_tree_and_refuse_a_bad_side():
    _, v = _jax_net(jax_define_G(3, 1, 8, "unet_128", norm="batch"),
                    (1, 128, 128, 3))
    sd = params_from_jax(v["params"], v["batch_stats"])
    port = define_G(3, 1, 8, "unet_128", "batch")
    assert set(sd) == set(port.state_dict())
    assert "unet.sub.downnorm.running_var" in sd
    assert "unet.sub.sub.sub.sub.sub.sub.up.weight" in sd  # the innermost
    np.testing.assert_array_equal(
        sd["unet.sub.up.weight"].numpy(),
        v["params"]["unet"]["sub"]["up"]["kernel"].transpose(2, 3, 0, 1))
    with pytest.raises(ValueError, match="divisible by 128"):
        port(torch.zeros(1, 96, 96, 3))


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_pixel_discriminator_matches_jax(norm):
    d, v = _jax_net(jax_define_D(4, 8, "pixel", norm=norm, compute_dtype=jnp.float32),
                    (1, 16, 16, 4))
    port = define_D(4, 8, "pixel", norm=norm)
    port.load_state_dict(d_params_from_jax(v["params"], v.get("batch_stats")),
                         strict=True)
    x = _x((2, 24, 24, 4))
    ref = _apply(d, v, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 24, 24, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("netG,size", [("unet_128", 128), ("resnet_6blocks", 32)])
def test_batch_norm_train_forwards_and_running_stats_match_jax(netG, size):
    """Two train forwards on different inputs: outputs, then the running
    statistics after each; then the eval forward reads them."""
    g, v = _jax_net(jax_define_G(3, 1, 8, netG, norm="batch", compute_dtype=jnp.float32),
                    (1, size, size, 3))
    port = define_G(3, 1, 8, netG, "batch")
    port.load_state_dict(params_from_jax(v["params"], v["batch_stats"]), strict=True)
    port.train()
    stats = v["batch_stats"]
    for seed in (1, 2):
        x = _x((2, size, size, 3), seed)
        ref, mut = _apply(g, {"params": v["params"], "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
        want = params_from_jax(v["params"], stats)
        own = port.state_dict()
        for k in want:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(own[k].numpy(), want[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
            if k.endswith("num_batches_tracked"):
                assert int(own[k]) == seed
    port.eval()
    x = _x((2, size, size, 3), 3)
    ref = _apply(g, {"params": v["params"], "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


def test_batch_norm_keeps_flax_variance_rule_not_torch():
    """The running variance moves by the biased batch variance (flax), not
    the unbiased one ``F.batch_norm(training=True)`` keeps; the normalised
    output divides by the biased one in both."""
    x = torch.from_numpy(_x((2, 3, 3, 4)) * 4.0 - 1.0)
    norm = Norm("batch", 4).train()
    with torch.no_grad():
        y = norm(x)
    xs = x.reshape(-1, 4).double()
    biased, unbiased = xs.var(0, unbiased=False), xs.var(0, unbiased=True)
    np.testing.assert_allclose(norm.running_var.numpy(), (0.9 + 0.1 * biased).numpy(),
                               rtol=1e-6)
    torch_var = torch.ones(4)
    F.batch_norm(x.permute(0, 3, 1, 2), torch.zeros(4), torch_var, training=True,
                 momentum=0.1, eps=1e-5)
    np.testing.assert_allclose(torch_var.numpy(), (0.9 + 0.1 * unbiased).numpy(),
                               rtol=1e-6)
    assert float((torch_var - norm.running_var).abs().min()) > 1e-3
    ref = (xs - xs.mean(0)) / torch.sqrt(biased + 1e-5)
    np.testing.assert_allclose(y.reshape(-1, 4).numpy(), ref.numpy(), atol=1e-5)
    # flax clamps a negative E[x^2] - E[x]^2 to 0 (a constant channel)
    flat = Norm("batch", 1).train()
    with torch.no_grad():
        flat(torch.full((2, 2, 2, 1), 3.0))
    assert float(flat.running_var) == pytest.approx(0.9)


# ------------------------------------------------------------ dropout
def _masks(shapes, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.random(s) < 0.5 for s in shapes]


def _shared_masks(monkeypatch, masks):
    """Both stacks draw the given keep-masks, in call order: JAX through
    ``jax.random.bernoulli`` (flax's dropout), the port through
    ``layers.keep_mask``."""
    jax_queue, port_queue = list(masks), list(masks)

    def jax_draw(key, p=0.5, shape=None):
        m = jax_queue.pop(0)
        assert tuple(shape) == m.shape and p == 0.5
        return jnp.asarray(m)

    def port_draw(shape, keep_prob, generator, device):
        m = port_queue.pop(0)
        assert tuple(shape) == m.shape and keep_prob == 0.5
        assert generator is not None
        return torch.from_numpy(m).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_draw)
    monkeypatch.setattr(layers, "keep_mask", port_draw)
    return jax_queue, port_queue


@pytest.mark.parametrize("netG,size,shapes", [
    ("resnet_6blocks", 32, [(2, 8, 8, 32)] * 6),
    # the JAX U-Net's middle blocks take the flag from the ramp blocks above
    # them, which have it off (``nirgan_tpu/models/unet.py:67-93``): no
    # layer drops out, in the port as in JAX
    ("unet_128", 128, [])])
def test_dropout_forward_matches_jax_under_a_shared_mask(monkeypatch, netG, size,
                                                         shapes):
    g, v = _jax_net(jax_define_G(3, 1, 8, netG, norm="instance", use_dropout=True,
                                 compute_dtype=jnp.float32), (1, size, size, 3))
    port = define_G(3, 1, 8, netG, "instance", use_dropout=True)
    port.load_state_dict(params_from_jax(v["params"]), strict=True)
    jq, pq = _shared_masks(monkeypatch, _masks(shapes))
    x = _x((2, size, size, 3))
    ref = _apply(g, v, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
    port.train()
    layers.set_dropout_generator(port, torch.Generator())
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert not jq and not pq  # every mask drawn, once a dropout layer
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # eval mode: no dropout, no draw
    port.eval()
    with torch.no_grad():
        a, b = port(torch.from_numpy(x)), port(torch.from_numpy(x))
    assert torch.equal(a, b)


def test_dropout_draws_from_its_generator():
    drop = layers.Dropout(0.5).train()
    x = torch.ones(4, 8, 8, 16)
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, drop(x))
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert 0.4 < float((a > 0).float().mean()) < 0.6


# ------------------------------------------------------------ trunk paddings
@pytest.mark.parametrize("padding", ["replicate", "zero"])
def test_padded_trunks_match_jax(padding):
    """The replicate and zero trunks (pad, then a VALID conv: kernel A's
    ``pad=0`` mode on a card), forward and the gradient of every weight."""
    g = JaxResnetGenerator(input_nc=3, output_nc=1, ngf=8, n_blocks=2,
                           padding_type=padding, compute_dtype=jnp.float32)
    params = _jax_net(g, (1, 32, 32, 3))[1]["params"]
    port = ResnetGenerator(3, 1, 8, n_blocks=2, padding_type=padding).eval()
    port.load_state_dict(params_from_jax(params), strict=True)
    x = _x((2, 32, 32, 3))
    target = _x((2, 32, 32, 1), 4)

    def loss(p):
        y = g.apply({"params": p}, jnp.asarray(x), train=False)
        return jnp.mean(jnp.abs(y - target)), y

    (_, ref), grads = _np(jax.jit(jax.value_and_grad(loss, has_aux=True))(params))
    y = port(torch.from_numpy(x))
    torch.mean(torch.abs(y - torch.from_numpy(target))).backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=0, atol=ATOL)
    _assert_grads_close({k: p.grad for k, p in port.named_parameters()},
                        params_from_jax(grads), "G")


@pytest.mark.parametrize("pad", [1, 2, 3])
def test_replicate_pad_adjoint_equals_fpad_autograd(pad):
    x = torch.randn(2, 5, 4, 3, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 5 + 2 * pad, 4 + 2 * pad, 3, dtype=torch.float64)
    y = F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="replicate").permute(0, 2, 3, 1)
    (want,) = torch.autograd.grad(y, x, g)
    torch.testing.assert_close(replicate_pad2d_adjoint(g, pad), want)
    mine = x.detach().clone().requires_grad_(True)
    out = replicate_pad2d(mine, pad)
    assert torch.equal(out, y) and out.is_contiguous()
    out.backward(g)
    torch.testing.assert_close(mine.grad, want)


@pytest.mark.parametrize("padding", ["replicate", "zero"])
def test_int8_trunk_refuses_a_padded_trunk(padding):
    """The int8 trunk with the replicate or zero border, once refused, now
    runs kernel D's matching gather (its plain version here): the pack
    serves within 36 dB of the float path (the JAX package's bound), and
    the padding makes a difference against the reflect trunk on the same
    pack.  ``tests/test_torch_int8_stage2.py`` holds it against JAX."""
    from nirgan_tpu_torch.ops import int8_trunk

    port = ResnetGenerator(3, 1, 8, n_blocks=2, padding_type=padding).eval()
    port.reset_parameters(torch.Generator().manual_seed(0),
                          port_inits.get_initializer("normal", 0.02))
    x = torch.from_numpy(_x((1, 32, 32, 3))) * 0.3
    with torch.inference_mode():
        pack = int8_trunk.quantize_trunk(port.state_dict(), port.n_blocks,
                                         int8_trunk.calibrate_trunk(port, x))
        got, flt = port(x, trunk_q=pack), port(x)
        port.padding_type = "reflect"
        reflect = port(x, trunk_q=pack)
    mse = float(torch.mean((got - flt) ** 2))
    assert 10 * np.log10(4.0 / mse) >= 36.0
    assert not torch.equal(got, reflect)


# ------------------------------------------------------------ once differentiable
def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32)

    return {
        "instance_norm": (lambda x: instance_norm(x, relu=True), t(2, 6, 6, 8)),
        "trunk_conv": (lambda x: trunk_conv(x, t(16, 8, 3, 3), t(16)), t(1, 6, 6, 8)),
        "head_conv": (lambda x: head_conv(x, t(1, 8, 7, 7), t(1)), t(1, 10, 10, 8)),
        "convt_k3s2": (lambda x: conv_transpose2d(x, t(8, 4, 3, 3)),
                       t(1, 5, 5, 8)),
    }


def _plain_instance_norm(x, eps=1e-5, relu=False, residual=None):
    """The JAX package's norm formula in PyTorch ops, which autograd
    differentiates to any order."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.square().mean(dim=(1, 2), keepdim=True) - mean.square()
    y = (x - mean.to(x.dtype)) * torch.reciprocal(torch.sqrt(var + eps)).to(x.dtype)
    y = torch.relu(y) if relu else y
    return y if residual is None else residual + y


@pytest.mark.parametrize("name", ["instance_norm", "trunk_conv", "head_conv",
                                  "convt_k3s2"])
def test_kernel_functions_refuse_a_double_backward(name):
    """The operators of G's kernels (A, C, B5) are once-differentiable: their
    first-order gradient stands, a backward through that gradient raises (on
    the CPU's plain route as on a card) instead of dropping the kernel's part
    of a second-order gradient; no JAX path differentiates G twice.  The
    instance norm, which D's under ``gradient_penalty`` needs, is
    differentiable twice: its second-order gradient equals autograd's
    through the plain formula (rtol 1e-4 of the largest value, f32)."""
    fn, x = _kernel_calls()[name]
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x).square().sum(), x, create_graph=True)
    assert torch.isfinite(g).all()
    if name != "instance_norm":
        with pytest.raises(RuntimeError, match="once_differentiable|differentiate twice"):
            g.square().sum().backward()
        return
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    xr = x.detach().clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(_plain_instance_norm(xr, relu=True).square().sum(), xr,
                                create_graph=True)
    (ggr,) = torch.autograd.grad(gr.square().sum(), xr)
    torch.testing.assert_close(g, gr, rtol=0, atol=1e-4 * float(gr.detach().abs().max()))
    torch.testing.assert_close(gg, ggr, rtol=0, atol=1e-4 * float(ggr.abs().max()))


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("skip", [False, True], ids=["no_skip", "skip"])
def test_instance_norm_second_order_gradgradcheck(relu, skip):
    """The second-order terms of the instance norm (the autograd formula of
    ``nirgan::instance_norm_bwd``, the plain route here) against
    ``torch.autograd.gradgradcheck``'s finite differences in f64, with the
    fused ReLU and the fused skip on and off (gradgradcheck's own
    tolerances: atol 1e-5, rtol 1e-3)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 4, 8), generator=g, dtype=torch.float64, requires_grad=True)
    r = torch.randn((2, 5, 4, 8), generator=g, dtype=torch.float64, requires_grad=True)

    def fn(x, r):
        return instance_norm(x, relu=relu, residual=r if skip else None)

    assert torch.autograd.gradcheck(fn, (x, r))
    assert torch.autograd.gradgradcheck(fn, (x, r))


# ------------------------------------------------------------ gradient penalty
@pytest.mark.parametrize("gp_type", ["mixed", "real", "fake"])
@pytest.mark.parametrize("norm", ["batch", "none", "instance"])
def test_gradient_penalty_matches_jax(monkeypatch, gp_type, norm):
    """The penalty and its gradient with respect to D's parameters (the
    second-order path through ``create_graph=True``) against JAX, alpha
    patched to one numpy draw on both sides.  Through the instance norm the
    conv biases ahead of it have a gradient of f32 noise (zero in exact
    arithmetic): both sides within 1e-5 of the network's largest, as
    ``_assert_grads_close`` holds them."""
    d, v = _jax_net(jax_define_D(4, 8, "basic", norm=norm, compute_dtype=jnp.float32),
                    (1, 24, 24, 4))
    port = define_D(4, 8, "basic", norm=norm)
    port.load_state_dict(d_params_from_jax(v["params"], v.get("batch_stats")),
                         strict=True)
    real, fake = _x((2, 24, 24, 4), 5), _x((2, 24, 24, 4), 6)
    alpha = np.random.default_rng(9).random((2, 1, 1, 1), dtype=np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(alpha))
    monkeypatch.setattr(port_gan, "interpolation_weights",
                        lambda n, ndim, generator, device: torch.from_numpy(alpha))
    stats = v.get("batch_stats", {})

    def apply_d(p, x):
        return d.apply({"params": p, **({"batch_stats": stats} if stats else {})}, x)

    ref, grads = _np(jax.jit(jax.value_and_grad(
        lambda p: jax_gradient_penalty(apply_d, p, jnp.asarray(real), jnp.asarray(fake),
                                       jax.random.PRNGKey(0), gp_type)))(v["params"]))
    got = gradient_penalty(port, torch.from_numpy(real), torch.from_numpy(fake),
                           gp_type, generator=torch.Generator())
    # through the instance norm JAX differentiates E[x^2] - E[x]^2 in f32
    # twice: its penalty lies 1.2e-5 to 4.9e-5 from one in f64 here, the
    # port's (the backward's closed form) 0.4e-5 to 1.6e-5
    rtol = 1e-4 if norm == "instance" else 2e-5
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=rtol, atol=2e-6)
    got.backward()
    want = d_params_from_jax(grads)
    net_max = max(float(g.abs().max()) for g in want.values())
    for k, p in port.named_parameters():
        # the last conv's bias does not reach the input's gradient: no grad
        # in torch, zeros in JAX
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((g - want[k]).abs().max())
        if norm == "instance" and _ahead_of_a_norm("D", k):
            # zero in exact arithmetic: f32 noise on both sides
            assert max(err, float(g.abs().max())) <= 1e-5 * net_max, (k, err)
            continue
        assert err <= 1e-4 * float(want[k].abs().max()) + 1e-6 * net_max, (k, err)


@pytest.mark.parametrize("netd", ["basic", "pixel"])
def test_gradient_penalty_through_the_instance_norm_raises(netd):
    """Once refused, the penalty now trains an instance-norm D (the default
    ``basic`` and the ``pixel`` D): its gradient with respect to every
    parameter equals autograd's through the plain norm formula (1e-4 of
    each tensor's largest value, 1e-6 of the network's, f32; a conv bias
    ahead of the norm, zero in exact arithmetic, within 1e-5 of the
    network's largest on both sides, as ``_assert_grads_close``); with
    ``lambda_gp`` 0 it is 0."""
    port = define_D(4, 8, netd, norm="instance",
                    generator=torch.Generator().manual_seed(1))
    real, fake = torch.from_numpy(_x((2, 24, 24, 4))), torch.from_numpy(_x((2, 24, 24, 4), 2))

    def grads():
        port.zero_grad(set_to_none=True)
        penalty = gradient_penalty(port, real, fake,
                                   generator=torch.Generator().manual_seed(0))
        penalty.backward()
        return float(penalty.detach()), {k: p.grad.clone() for k, p in port.named_parameters()
                                         if p.grad is not None}

    got_p, got = grads()
    with mock.patch.object(layers, "instance_norm", _plain_instance_norm):
        want_p, want = grads()
    assert got.keys() == want.keys() and len(got) >= 2
    assert got_p == pytest.approx(want_p, rel=1e-5)
    net_max = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        assert torch.isfinite(got[k]).all()
        err = float((got[k] - g).abs().max())
        if _ahead_of_a_norm("D", k):
            # zero in exact arithmetic: f32 noise on both sides
            assert max(err, float(got[k].abs().max())) <= 1e-5 * net_max, (k, err)
            continue
        assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * net_max, (k, err)
    assert float(gradient_penalty(port, real, fake, lambda_gp=0.0)) == 0.0


# ------------------------------------------------------------ init types
def _big_weights():
    # a conv (OIHW), a transposed conv (IOHW) and a dense layer, with the
    # HWIO / (in, out) shapes the JAX initialisers see
    return [((64, 32, 3, 3), False, (3, 3, 32, 64)),
            ((64, 32, 4, 4), True, (4, 4, 64, 32)),
            ((48, 256), False, (256, 48))]


def test_fans_equal_the_jax_fans():
    for shape, transposed, hwio in _big_weights():
        assert port_inits._fans(shape, transposed) == jax_inits._fans(hwio)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_types_statistics_match_jax(init_type):
    gain = 0.02
    port_init = port_inits.get_initializer(init_type, gain)
    jax_init = jax_inits.get_initializer(init_type, gain)
    for shape, transposed, hwio in _big_weights():
        w = port_init(torch.empty(shape), torch.Generator().manual_seed(1),
                      transposed=transposed)
        ref = np.asarray(jax_init(jax.random.PRNGKey(1), hwio))
        assert torch.equal(w, port_init(torch.empty(shape),
                                        torch.Generator().manual_seed(1),
                                        transposed=transposed))
        assert abs(float(w.mean())) < 0.1 * float(w.std())
        np.testing.assert_allclose(float(w.std()), float(ref.std()), rtol=0.05)
        if init_type == "orthogonal":
            # output channel first: (out, rest), orthonormal rows or columns,
            # scaled by the gain, as JAX's (rest, out) matrix
            m = (w.transpose(0, 1) if transposed else w).reshape(
                hwio[-1], -1).double()
            gram = m @ m.t() if m.shape[0] <= m.shape[1] else m.t() @ m
            torch.testing.assert_close(gram, gain ** 2 * torch.eye(gram.shape[0],
                                                                   dtype=torch.float64),
                                       rtol=0, atol=1e-8)
            r = ref.reshape(-1, hwio[-1]).astype(np.float64)
            jgram = r.T @ r if r.shape[0] >= r.shape[1] else r @ r.T
            np.testing.assert_allclose(jgram, gain ** 2 * np.eye(jgram.shape[0]),
                                       atol=1e-8)


def test_batchnorm_scale_init_and_every_init_type_builds():
    w = port_inits.batchnorm_scale_init(torch.empty(4096), torch.Generator().manual_seed(2))
    ref = np.asarray(jax_inits.batchnorm_scale_init(jax.random.PRNGKey(2), (4096,)))
    assert abs(float(w.mean()) - 1.0) < 2e-3 and abs(float(ref.mean()) - 1.0) < 2e-3
    np.testing.assert_allclose(float(w.std()), float(ref.std()), rtol=0.05)
    for init_type in ("normal", "xavier", "kaiming", "orthogonal"):
        g = define_G(3, 1, 8, "unet_256", "batch", init_type=init_type)
        assert 0.9 < float(g.unet.sub.downnorm.weight.detach().mean()) < 1.1
        define_D(4, 8, "pixel", "batch", init_type=init_type)
    with pytest.raises(NotImplementedError):
        port_inits.get_initializer("uniform")


# ------------------------------------------------------------ the fused step
def _cfg(**overrides):
    cfg = load_config(os.path.join(REPO_ROOT, "configs/config_px2px.yaml"))
    bc = cfg.base_configs
    bc.netG, bc.ngf, bc.ndf = "resnet_6blocks", 8, 8
    cfg.Data.padding_amount = 2
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.train_metrics_every = 2
    for k, v in overrides.items():
        bc[k] = v
    if bc.netG.startswith("unet"):
        cfg.Data.padding = False  # a U-Net needs 2^num_downs-divisible sides
    return cfg


def _batch(size, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.random((2, 3, size, size), dtype=np.float32)
    return {"rgb": rgb, "nir": (0.6 * rgb[:, 1:2] + 0.4 * rgb[:, 2:3])}


def _jax_state(jt, size):
    """The JAX task's train state with seeded weights and statistics
    (``_fill``) and fresh optimizers."""
    shapes = jax.eval_shape(lambda: jt.init_state(seed=0, image_size=size))
    return _np(create_state(jax.random.PRNGKey(0), _fill(shapes.params_g, 1),
                            _fill(shapes.params_d, 2), lr=float(jt.opt.lr),
                            beta1=float(jt.opt.beta1),
                            stats_g=_fill(shapes.stats_g, 3),
                            stats_d=_fill(shapes.stats_d, 4)))


@pytest.mark.parametrize("overrides,size,masks", [
    # batch norm in G and D, dropout in G's blocks, the pixel D
    ({"norm": "batch", "no_dropout": False, "netD": "pixel"}, 32,
     [(2, 9, 9, 32)] * 6),
    # the U-Net (instance norm, kernel B's route) with the PatchGAN
    ({"netG": "unet_128"}, 128, None),
])
def test_fused_step_with_each_variant_matches_jax(monkeypatch, overrides, size, masks):
    """Step 1 of the port's ``train_step`` against ``make_train_step`` from
    the same weights and running statistics, at the bar of
    ``tests/test_torch_train.py``'s fused step: rtol 2e-5, atol 2e-6 on the
    loss terms; the G and D running statistics after the step (G's once, D's
    three times: fake, real, the G loss's fake) at rtol 1e-5.  The dropout
    draws one numpy keep-mask on both sides."""
    cfg = _cfg(**overrides)
    jt = JaxPx2PxTask(cfg)
    state = _jax_state(jt, size)
    port = Px2PxTask(cfg, device="cpu", seed=0)
    port.netG.load_state_dict(params_from_jax(state.params_g, state.stats_g), strict=True)
    port.netD.load_state_dict(d_params_from_jax(state.params_d, state.stats_d),
                              strict=True)
    assert port.has_bn == (cfg.base_configs.norm == "batch")
    assert port.uses_dropout == (masks is not None)
    if masks is not None:
        _shared_masks(monkeypatch, _masks(masks))
    batch = _batch(size)
    new, ref = _np(jax.jit(jt.make_train_step())(jax.device_put(state),
                                                 jt.extract_batch(batch)))
    ref = {k: float(v) for k, v in ref.items()}
    st = port.init_state()
    got = {k: float(v) for k, v in port.train_step(st, port.extract_batch(batch)).items()}
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)
    for net, want in ((port.netG, params_from_jax(new.params_g, new.stats_g)),
                      (port.netD, d_params_from_jax(new.params_d, new.stats_d))):
        own = net.state_dict()
        running = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(running) == 2 * sum(1 for m in net.modules() if isinstance(m, Norm)
                                       and m.norm_type == "batch")
        for k in running:
            np.testing.assert_allclose(own[k].numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    if port.has_bn:
        assert int(port.netD.norm1.num_batches_tracked) == 3
        assert int(port.netG.n0.num_batches_tracked) == 1
    # serving reads the running averages with the dropout off: two calls agree
    x = _batch(size, 1)["rgb"]
    assert np.array_equal(port.predict_step(x), port.predict_step(x))
    assert not port.netG.training


def test_int8_serving_refused_for_variants():
    for overrides in ({"norm": "batch"}, {"no_dropout": False}, {"netG": "unet_128"}):
        cfg = _cfg(**overrides)
        cfg.tpu.serving_quant = "int8"
        with pytest.warns(UserWarning, match="int8 ignored"):
            task = Px2PxTask(cfg, device="cpu")
        assert not task.wants_int8_serving()


def test_batch_norm_unet_serving_matches_jax(tmp_path):
    """``predict_step`` of an unpadded batch-norm U-Net bound to the same
    weights and running statistics: the eval forward at 2e-5; and the
    serving CLI refuses a baseline config, as the JAX CLI cannot build
    one."""
    from types import SimpleNamespace

    from nirgan_tpu_torch import create_synthetic_dataset as serve

    cfg = _cfg(netG="unet_128", norm="batch")
    cfg.tpu.shape_buckets = [128]
    jt = JaxPx2PxTask(cfg)
    state = _jax_state(jt, 128)
    jt.bind(SimpleNamespace(params_g=state.params_g, stats_g=state.stats_g))
    port = Px2PxTask(cfg, device="cpu")
    port.bind(params_from_jax(state.params_g, state.stats_g))
    rgb = _batch(128, 3)["rgb"]
    np.testing.assert_allclose(port.predict_step(rgb), jt.predict_step(rgb),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="baseline"):
        serve.main(["--config", os.path.join(REPO_ROOT, "configs/config_baselines.yaml"),
                    "--device", "cpu", "--data", str(tmp_path)])


def test_unet_serving_refuses_a_padded_input():
    cfg = _cfg(netG="unet_128")
    cfg.Data.padding = True
    task = Px2PxTask(cfg, device="cpu")
    with pytest.raises(ValueError, match="padding"):
        task.predict_step(_batch(128)["rgb"])


# ------------------------------------------------------------ resume
def _variant_config_file(tmp_path):
    import yaml

    cfg = _cfg(norm="batch", no_dropout=False).to_dict()
    cfg["Data"].update(train_batch_size=2, val_batch_size=2, num_workers=0)
    cfg["Data"]["fake_settings"].update(image_size=32, length=4)
    cfg["tpu"]["shape_buckets"] = [32]
    path = tmp_path / "variant.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def test_resume_repeats_a_run_bit_for_bit(tmp_path):
    """Batch norm and dropout: 4 steps in one run equal 2 steps, a resume
    and 2 more (2 steps an epoch, each epoch in the same order): weights,
    running statistics, optimizer states and the dropout generator, bit
    for bit on the CPU."""
    cfg = _variant_config_file(tmp_path)
    base = ["--config", cfg, "--device", "cpu", "--log-every", "2"]
    whole = str(tmp_path / "whole")
    cli.main(base + ["--logdir", whole, "--max-steps", "4"])
    split = str(tmp_path / "split")
    cli.main(base + ["--logdir", split, "--max-steps", "2"])
    state = cli.main(base + ["--resume", split, "--max-steps", "4"])
    assert state.step == 4
    a = torch.load(os.path.join(whole, "last.pt"), weights_only=True)
    b = torch.load(os.path.join(split, "last.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["rng"], b["rng"])
    for net in ("G", "D"):
        assert any("running_var" in k for k in a[net])
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for opt in ("opt_g", "opt_d"):
        for i, s in a[opt]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[key], b[opt]["state"][i][key]), (opt, i, key)
