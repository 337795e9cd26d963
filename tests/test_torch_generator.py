"""The port's generator against the JAX ``ResnetGenerator``: JAX params from
a seed, exported through ``weights.params_from_jax`` and loaded with
``strict=True``, then both forwards on the same seeded input in f32 on the
CPU (atol 2e-5, the cross-stack bound of tests/test_torch_export.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.models.generator import ResnetGenerator as JaxResnetGenerator
from nirgan_tpu.ops.pad import reflect_pad2d as jax_reflect_pad2d
from nirgan_tpu.train.torch_convert import export_resnet_generator
from nirgan_tpu_torch.models import ResnetGenerator, define_G
from nirgan_tpu_torch.ops.pad import reflect_pad2d
from nirgan_tpu_torch.weights import load_reference_ckpt, params_from_jax


def _jax_generator(ngf, n_blocks, size, seed=0):
    g = JaxResnetGenerator(input_nc=3, output_nc=1, ngf=ngf, n_blocks=n_blocks,
                           compute_dtype=jnp.float32)
    params = g.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))["params"]
    return g, jax.device_get(params)


@pytest.mark.parametrize("ngf,n_blocks,size,pad", [
    (8, 2, 48, 0), (16, 9, 48, 0), (8, 9, 64, 10)])
def test_generator_matches_jax(ngf, n_blocks, size, pad):
    g, params = _jax_generator(ngf, n_blocks, size + 2 * pad)
    port = ResnetGenerator(3, 1, ngf, n_blocks=n_blocks)
    missing, unexpected = port.load_state_dict(params_from_jax(params), strict=True)
    assert not missing and not unexpected
    x = np.random.default_rng(1).random((2, size, size, 3), dtype=np.float32)
    xj = jax_reflect_pad2d(jnp.asarray(x), pad) if pad else jnp.asarray(x)
    ref = np.asarray(g.apply({"params": params}, xj, train=False))
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        got = port(reflect_pad2d(xt, pad) if pad else xt).numpy()
    assert got.shape == (2, size + 2 * pad, size + 2 * pad, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_state_dict_names_follow_the_jax_tree():
    _, params = _jax_generator(8, 2, 32)
    sd = params_from_jax(params)
    port_keys = set(ResnetGenerator(3, 1, 8, n_blocks=2).state_dict())
    assert set(sd) == port_keys
    assert {k.split(".")[0] for k in sd} == {"c0", "d0", "d1", "r0", "r1",
                                             "u0", "u1", "c1"}
    # conv HWIO -> OIHW, conv-transpose HWIO -> IOHW without a flip
    np.testing.assert_array_equal(sd["r1.conv2.weight"].numpy(),
                                  params["r1"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["u0.weight"].numpy(),
                                  params["u0"]["kernel"].transpose(2, 3, 0, 1))


def test_load_reference_ckpt_roundtrip(tmp_path):
    """A reference-layout Lightning .ckpt (netG.model.<i> keys, as
    export_resnet_generator writes it) loads into the port unchanged."""
    _, params = _jax_generator(8, 9, 32)
    sd_ref = export_resnet_generator(params, prefix="netG.", n_blocks=9)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd_ref.items()}}, path)
    cfg = load_config("configs/config_px2px.yaml")
    cfg.base_configs.ngf = 8
    loaded = load_reference_ckpt(path, cfg)
    direct = params_from_jax(params)
    assert set(loaded) == set(direct)
    for k in direct:
        torch.testing.assert_close(loaded[k], direct[k], rtol=0, atol=0)
    define_G(3, 1, 8, "resnet_9blocks", "instance").load_state_dict(loaded, strict=True)


def test_define_G_is_seeded_and_rejects_unported():
    a = define_G(3, 1, 8, "resnet_6blocks", "instance",
                 generator=torch.Generator().manual_seed(3))
    b = define_G(3, 1, 8, "resnet_6blocks", "instance",
                 generator=torch.Generator().manual_seed(3))
    assert a.n_blocks == 6
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    assert float(a.c0.bias.detach().abs().sum()) == 0.0
    # the U-Nets and batch norm are ported (tests/test_torch_variants.py);
    # a name the reference does not know is refused
    assert define_G(3, 1, 8, "unet_256", "instance").num_downs == 8
    assert define_G(3, 1, 8, "resnet_9blocks", "batch").n0.running_var.shape == (8,)
    with pytest.raises(NotImplementedError):
        define_G(3, 1, 8, "resnet_12blocks", "instance")
