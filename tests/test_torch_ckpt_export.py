"""The port's reference-checkpoint exporter against the JAX package's: from
the same seeded JAX parameters, ``weights.export_reference_weights`` (fed
the port's state_dicts) must write the keys and tensors of
``nirgan_tpu.train.torch_convert.export_px2px_checkpoint``, bit for bit,
for every generator and discriminator the configs name, and read back
through ``load_reference_weights`` to the port's state_dicts, bit for bit.
Then ``python -m nirgan_tpu_torch.export_torch_ckpt`` on a run of the
port's trainer."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.models.factory import define_D as jax_define_D
from nirgan_tpu.models.factory import define_G as jax_define_G
from nirgan_tpu.models.factory import define_G_inject as jax_define_G_inject
from nirgan_tpu.train.torch_convert import export_px2px_checkpoint
from nirgan_tpu_torch import export_torch_ckpt
from nirgan_tpu_torch.weights import (
    d_params_from_jax,
    export_reference_weights,
    load_reference_weights,
    params_from_jax,
)

CONFIG = "configs/config_px2px.yaml"
SATCLIP_CONFIG = "configs/config_px2px_SatCLIP.yaml"


def _fill(shapes, seed):
    """Seeded numpy values (N(0, 0.02); batch-norm scales N(1, 0.1)) in the
    shapes of a ``jax.eval_shape`` tree: tracing the init, not running it."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        z = rng.standard_normal(sd.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(getattr(path[-1], "key", "")) == "scale" else 0.02 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(net, shape, seed, *extra):
    x = jnp.zeros(shape)
    return _fill(jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, *extra)),
                 seed)["params"]


# (generator, dropout, norm, inject), then the discriminator's (netD, n_layers_D)
GENERATORS = [("resnet_9blocks", False, "instance", False),
              ("resnet_6blocks", False, "instance", False),
              ("resnet_9blocks", True, "instance", False),
              ("resnet_6blocks", True, "instance", False),
              ("unet_128", False, "instance", False),
              ("unet_256", False, "instance", False),
              ("resnet_9blocks", False, "instance", True),
              ("resnet_6blocks", False, "batch", False)]
DISCRIMINATORS = [("basic", 3), ("n_layers", 2), ("n_layers", 4), ("pixel", 3)]


def _case(netG, dropout, norm, inject, netD, n_layers):
    """The config and the seeded JAX params (G, D) of one combination."""
    cfg = load_config(SATCLIP_CONFIG if inject else CONFIG)
    bc = cfg.base_configs
    bc.netG, bc.no_dropout, bc.norm = netG, not dropout, norm
    bc.ngf, bc.ndf, bc.netD, bc.n_layers_D = 8, 8, netD, n_layers
    side = 128 if netG == "unet_128" else 256 if netG == "unet_256" else 32
    if inject:
        g = _params(jax_define_G_inject(cfg), (1, side, side, 3), 1,
                    jnp.zeros((1, 256)))
    else:
        g = _params(jax_define_G(3, 1, 8, netG, norm=norm, use_dropout=dropout),
                    (1, side, side, 3), 1)
    d = _params(jax_define_D(4, 8, netD, n_layers, norm=norm), (1, 32, 32, 4), 2)
    return cfg, g, d


def _cases():
    for gen in GENERATORS:
        yield pytest.param(*gen, "basic", 3, id="-".join(map(str, gen)))
    for disc in DISCRIMINATORS[1:]:
        yield pytest.param("resnet_6blocks", False, "instance", False, *disc,
                           id="-".join(map(str, disc)))
    yield pytest.param("resnet_6blocks", False, "batch", False, "pixel", 3,
                       id="pixel-batch")


@pytest.mark.parametrize("netG,dropout,norm,inject,netD,n_layers", list(_cases()))
def test_export_equals_the_jax_exporter_and_round_trips(
        tmp_path, netG, dropout, norm, inject, netD, n_layers):
    """Same keys, same f32 tensors bit for bit as ``export_px2px_checkpoint``
    (no norm exported in either); an instance-norm pair reads back through
    ``load_reference_weights`` to the port's state_dicts bit for bit."""
    cfg, g, d = _case(netG, dropout, norm, inject, netD, n_layers)
    path = export_px2px_checkpoint(g, d, cfg, str(tmp_path / "jax.ckpt"))
    ref = torch.load(path, weights_only=True)["state_dict"]
    port_g, port_d = params_from_jax(g), d_params_from_jax(d)
    got = export_reference_weights(port_g, port_d, cfg)
    assert set(got) == set(ref)
    assert any(k.startswith("netD.") for k in got)
    if inject:
        assert {"netG.fc.weight", "netG.scale_param"} <= set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == torch.float32, k
        assert got[k].is_contiguous() and torch.equal(got[k], ref[k]), k
    if norm == "instance":
        back = load_reference_weights({k: v.numpy() for k, v in got.items()}, cfg)
        for mine, theirs in ((port_g, back["netG"]), (port_d, back["netD"])):
            assert set(mine) == set(theirs)
            assert all(torch.equal(mine[k], theirs[k]) for k in mine)


def test_generator_only_export(tmp_path):
    cfg, g, _ = _case("resnet_6blocks", False, "instance", False, "basic", 3)
    path = export_px2px_checkpoint(g, None, cfg, str(tmp_path / "jax.ckpt"))
    ref = torch.load(path, weights_only=True)["state_dict"]
    got = export_reference_weights(params_from_jax(g), None, cfg)
    assert set(got) == set(ref) and all(k.startswith("netG.") for k in got)


def test_export_cli_writes_a_run_as_a_reference_ckpt(tmp_path, capsys):
    """A run of the port's trainer (its dir, or ``last.pt``) exported by the
    CLI loads back into a task that serves the trained generator's output
    bit for bit; ``--no-discriminator`` drops ``netD.*``; anything but a
    checkpoint of the trainer is refused."""
    from nirgan_tpu_torch.config import load_config as port_load_config
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train import cli
    from tests.test_torch_train import _tiny_config_file

    cfg_path = _tiny_config_file(tmp_path)
    run = str(tmp_path / "run")
    trained = cli.main(["--config", cfg_path, "--device", "cpu", "--max-steps", "2",
                        "--logdir", run])
    assert trained.step == 2
    out = str(tmp_path / "x.ckpt")
    export_torch_ckpt.main(["--config", cfg_path, "--ckpt", os.path.join(run, "last.pt"),
                            "--out", out])
    assert "wrote netG+netD" in capsys.readouterr().out
    cfg = port_load_config(cfg_path)
    sd = torch.load(out, weights_only=True)["state_dict"]
    assert any(k.startswith("netD.") for k in sd)
    blob = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    served, original = (Px2PxTask(cfg, device="cpu", seed=7) for _ in range(2))
    served.bind(load_reference_weights(out, cfg)["netG"])
    original.bind(blob["G"])
    rgb = np.random.default_rng(0).random((2, 3, 32, 32), np.float32)
    np.testing.assert_array_equal(served.predict_step(rgb), original.predict_step(rgb))

    export_torch_ckpt.main(["--config", cfg_path, "--ckpt", run, "--out", out,
                            "--no-discriminator"])
    assert not any(k.startswith("netD.")
                   for k in torch.load(out, weights_only=True)["state_dict"])
    torch.save({"state_dict": sd}, str(tmp_path / "ref.pt"))
    with pytest.raises(ValueError, match="not a checkpoint of the port's trainer"):
        export_torch_ckpt.main(["--config", cfg_path, "--ckpt", str(tmp_path / "ref.pt")])
    os.makedirs(tmp_path / "orbax" / "last")
    with pytest.raises(ValueError, match="orbax"):
        export_torch_ckpt.main(["--config", cfg_path, "--ckpt", str(tmp_path / "orbax")])
