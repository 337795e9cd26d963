"""The port's training half against the JAX package, on the CPU in f32 at a
small size (ngf 8, ndf 8, resnet_6blocks, 64^2 tiles, reflect pad 4, batch
2): the discriminator, the losses and metrics, Adam, the gradients of one
fused step, the loss terms of three fused steps, and the training CLI with
its checkpoints and resume."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nirgan_tpu.config import load_config
from nirgan_tpu.losses import calculate_metrics as jax_calculate_metrics
from nirgan_tpu.losses import gan_loss as jax_gan_loss
from nirgan_tpu.losses import l1_loss as jax_l1_loss
from nirgan_tpu.losses.pixel import ssim as jax_ssim
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch.losses import calculate_metrics, gan_loss, ssim
from nirgan_tpu_torch.models import define_D
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS, METRIC_KEYS
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.train.trainer import Trainer
from nirgan_tpu_torch.weights import d_params_from_jax, params_from_jax
from tests.conftest import REPO_ROOT

SIZE, PAD, N_STEPS = 64, 4, 3
LR, BETA1 = 2e-4, 0.5


def _config(size=SIZE):
    cfg = load_config(os.path.join(REPO_ROOT, "configs/config_px2px.yaml"))
    bc = cfg.base_configs
    bc.netG, bc.ngf, bc.ndf = "resnet_6blocks", 8, 8
    cfg.Data.padding_amount = PAD
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.train_metrics_every = 2
    cfg.tpu.shape_buckets = [size]
    return cfg


def _batch(seed):
    """Smooth seeded RGB (bicubic from 1/8 scale) and an NIR that is a
    clipped linear function of it, NCHW f32 as the data contract."""
    rng = np.random.default_rng(seed)
    base = rng.random((2, 3, SIZE // 8, SIZE // 8)).astype(np.float32)
    rgb = torch.nn.functional.interpolate(
        torch.from_numpy(base), size=(SIZE, SIZE), mode="bicubic",
        align_corners=False).clamp(0, 1)
    nir = (0.6 * rgb[:, 1:2] + 0.4 * rgb[:, 2:3]).clamp(0, 1)
    return {"rgb": rgb.numpy(), "nir": nir.numpy()}


def _port_task(cfg, jax_state):
    task = Px2PxTask(cfg, device="cpu", seed=0)
    task.netG.load_state_dict(params_from_jax(jax.device_get(jax_state.params_g)),
                              strict=True)
    task.netD.load_state_dict(d_params_from_jax(jax.device_get(jax_state.params_d)),
                              strict=True)
    return task


@pytest.fixture(scope="module")
def jax_pair():
    cfg = _config()
    jt = JaxPx2PxTask(cfg)
    state = jax.jit(lambda: jt.init_state(seed=0, image_size=SIZE))()
    return cfg, jt, jax.device_get(state)


# ------------------------------------------------------------ discriminator
def test_discriminator_matches_jax(jax_pair):
    cfg, jt, state = jax_pair
    port = _port_task(cfg, state)
    x = np.random.default_rng(3).random((2, SIZE, SIZE, 4), dtype=np.float32)
    ref = np.asarray(jt.netD.apply({"params": state.params_d}, jnp.asarray(x)))
    with torch.no_grad():
        got = port.netD(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, SIZE // 8 - 2, SIZE // 8 - 2, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_discriminator_names_follow_the_jax_tree(jax_pair):
    _, _, state = jax_pair
    sd = d_params_from_jax(state.params_d)
    d = define_D(4, 8, "n_layers", n_layers_D=3, norm="instance")
    assert set(sd) == set(d.state_dict())
    assert {k.split(".")[0] for k in sd} == {f"conv{i}" for i in range(5)}
    assert "conv4.bias" in sd and "conv0.bias" in sd
    np.testing.assert_array_equal(sd["conv2.weight"].numpy(),
                                  state.params_d["conv2"]["kernel"].transpose(3, 2, 0, 1))
    # the pixel D is ported (tests/test_torch_variants.py); an unknown name
    # is refused
    assert define_D(4, 8, "pixel").conv2.weight.shape == (1, 16, 1, 1)
    with pytest.raises(NotImplementedError):
        define_D(4, 8, "patch")


# ------------------------------------------------------------ losses
@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    x = (np.random.default_rng(4).standard_normal((2, 6, 6, 1)) * 2).astype(np.float32)
    ref = float(jax_gan_loss(jnp.asarray(x), real, mode))
    got = float(gan_loss(torch.from_numpy(x), real, mode))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window", [5, 11])
def test_ssim_matches_jax(window):
    rng = np.random.default_rng(window)
    a = rng.random((2, 24, 20, 1), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ref = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b), window))
    got = ssim(torch.from_numpy(a), torch.from_numpy(b), window).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_calculate_metrics_matches_jax(masked):
    rng = np.random.default_rng(8)
    a = rng.random((3, 16, 16, 1), dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if masked else None
    ref = jax_calculate_metrics(jnp.asarray(a), jnp.asarray(b), "val",
                                mask=None if mask is None else jnp.asarray(mask))
    got = calculate_metrics(torch.from_numpy(a), torch.from_numpy(b), "val",
                            mask=None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ Adam
def test_adam_matches_optax_with_a_live_lr():
    """torch Adam(lr, (beta1, 0.999), 1e-8) vs the JAX package's optax
    scale_by_adam + scale(-1) times the live LR, on the same numpy
    gradients over 5 steps, the LR cut after step 3 as the plateau
    scheduler does."""
    from nirgan_tpu.train.state import adam_for as jax_adam_for
    from nirgan_tpu_torch.train.state import TrainState, adam_for

    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10 ** -i
              for k, v in p0.items()} for i in range(5)]
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()})
    state = TrainState(step=0, opt_g=adam_for(module, LR, BETA1),
                       opt_d=adam_for(torch.nn.Linear(1, 1), LR, BETA1))
    tx = jax_adam_for(p0, BETA1)
    params, opt = {k: jnp.asarray(v) for k, v in p0.items()}, None
    opt = tx.init(params)
    for i, g in enumerate(grads):
        lr = LR if i < 3 else LR * 0.1
        state.set_lr(lr, lr)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        state.opt_g.step()
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * lr, upd))
    assert state.lr_g == pytest.approx(LR * 0.1)
    for k in p0:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=0, atol=1e-7)


# ------------------------------------------------------------ the fused step
def _ahead_of_a_norm(tag, name):
    """The conv biases whose output feeds an instance norm, which removes
    them: their gradient is zero in exact arithmetic.  Every G bias but the
    head's; D's between its first and last conv."""
    if tag == "G":
        return name.endswith(".bias") and name != "c1.bias"
    return name in ("conv1.bias", "conv2.bias", "conv3.bias")


def _assert_grads_close(got, ref, tag):
    """Each gradient within 1e-4 of its reference's largest entry.  A bias
    ahead of a norm has a reference of f32 noise (measured at most 2.4e-6
    of the network's largest gradient, the smallest other tensor 1.6e-3):
    it must stay below 1e-5 of that on both sides."""
    assert set(got) == set(ref)
    net_max = max(float(g.abs().max()) for g in ref.values())
    for k, g in got.items():
        assert g is not None and bool(torch.isfinite(g).all()), (tag, k)
        err = float((g - ref[k]).abs().max())
        if _ahead_of_a_norm(tag, k):
            assert float(ref[k].abs().max()) <= 1e-5 * net_max, (tag, k)
            assert err <= 1e-5 * net_max, (tag, k, err, net_max)
        else:
            scale = float(ref[k].abs().max())
            assert err <= 1e-4 * scale, (tag, k, err, scale)


def test_step_gradients_match_jax(jax_pair):
    """G and D gradients of one port step vs jax.grad of the same losses,
    built from the JAX task's own applies and losses.  LR 0 keeps D as it
    was, so G's loss runs through the D the JAX grads see.  Bound: 1e-4 of
    each tensor's largest entry (measured at most 1.7e-5, G's d0 weight),
    and the biases ahead of a norm as ``_assert_grads_close`` says."""
    cfg, jt, state = jax_pair
    batch = _batch(0)
    ex = jt.extract_batch(batch)
    pg0, pd0 = state.params_g, state.params_d

    def g_loss(pg):
        pred = jt.g_apply(pg, ex["rgb"], train=True)
        logits = jt.d_apply(pd0, jnp.concatenate([ex["rgb"], pred], -1))
        return (jax_gan_loss(logits, True, "lsgan") * jt.lambda_gan
                + jax_l1_loss(pred, ex["nir"]) * jt.lambda_l1)

    def d_loss(pd):
        pred = jax.lax.stop_gradient(jt.g_apply(pg0, ex["rgb"], train=True))
        fake = jnp.concatenate([ex["rgb"], pred], -1)
        real = jnp.concatenate([ex["rgb"], ex["nir"]], -1)
        return (jax_gan_loss(jt.d_apply(pd, fake), False, "lsgan")
                + jax_gan_loss(jt.d_apply(pd, real), True, "lsgan"))

    ref = {"G": params_from_jax(jax.device_get(jax.jit(jax.grad(g_loss))(pg0))),
           "D": d_params_from_jax(jax.device_get(jax.jit(jax.grad(d_loss))(pd0)))}

    port = _port_task(cfg, state)
    st = port.init_state()
    st.set_lr(0.0, 0.0)
    port.train_step(st, port.extract_batch(batch))
    for tag, net in (("G", port.netG), ("D", port.netD)):
        _assert_grads_close({k: p.grad for k, p in net.named_parameters()},
                           ref[tag], tag)


def test_fused_step_loss_terms_match_jax(jax_pair):
    """The 8 model_loss/* terms of the port's train_step vs the JAX
    make_train_step over 3 steps of distinct batches from the same weights.
    Step 1: rtol 2e-5, atol 2e-6, the bar the JAX package holds itself to
    against the torch reference (tests/test_train_step_parity.py).  Step 2:
    that test's later-step rtol 5e-4, atol 5e-5 (measured 2.4e-4).  Step 3:
    rtol 1e-2, atol 1e-4 (measured 3.3e-3).  Adam's first step moves every
    parameter by about +-lr whatever its gradient's size, so entries whose
    gradient is f32 noise land 2 lr apart in the two stacks, and the GAN's
    updates amplify that: in the port alone, a 1e-6 relative perturbation
    of the weights grows to 4e-4 in the loss terms by step 3.  The train
    metrics follow the cadence: NaN on steps 1 and 3, computed on step 2."""
    cfg, jt, state = jax_pair
    port = _port_task(cfg, state)
    st = port.init_state()
    step = jt.make_train_step()
    jstate = jax.device_put(state)
    for s in range(N_STEPS):
        batch = _batch(s)
        jstate, ref = step(jstate, jt.extract_batch(batch))
        ref = {k: float(v) for k, v in jax.device_get(ref).items()}
        got = {k: float(v) for k, v in
               port.train_step(st, port.extract_batch(batch)).items()}
        assert set(got) == set(LOSS_KEYS) | set(METRIC_KEYS) == set(ref)
        rtol, atol = ((2e-5, 2e-6), (5e-4, 5e-5), (1e-2, 1e-4))[s]
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                       err_msg=f"step {s + 1} {k}")
        for k in METRIC_KEYS:
            if s == 1:
                np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-5,
                                           err_msg=f"step {s + 1} {k}")
            else:
                assert np.isnan(got[k]) and np.isnan(ref[k]), (s, k)
    assert st.step == N_STEPS


def test_extract_batch_keeps_dn_integers_and_divides_on_device():
    cfg = _config(32)
    task = Px2PxTask(cfg, device="cpu")
    dn = np.random.default_rng(1).integers(0, 10000, (2, 3, 8, 8), np.uint16)
    ex = task.extract_batch({"rgb": dn, "nir": dn[:, :1].astype(np.float64)})
    assert ex["rgb"].dtype == torch.uint16 and tuple(ex["rgb"].shape) == (2, 8, 8, 3)
    assert ex["nir"].dtype == torch.float32
    got = task._dn_to_reflectance(ex["rgb"], torch.float32).numpy()
    np.testing.assert_array_equal(got, dn.transpose(0, 2, 3, 1).astype(np.float32)
                                  / np.float32(10000.0))


# ------------------------------------------------------------ trainer and CLI
def _tiny_config_file(tmp_path, **tpu):
    import yaml

    cfg = _config(32).to_dict()
    cfg["Data"].update(train_batch_size=2, val_batch_size=2, num_workers=0)
    cfg["Data"]["fake_settings"].update(image_size=32, length=4)
    cfg["tpu"].update(tpu)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """2 steps an epoch on the fake data: 4 steps give two validations,
    both checkpoints and the scheduler state; a resume runs on from step 4
    with the optimizers' state."""
    cfg = _tiny_config_file(tmp_path)
    run = str(tmp_path / "run")
    argv = ["--config", cfg, "--device", "cpu", "--logdir", run, "--log-every", "2"]
    state = cli.main(argv + ["--max-steps", "4"])
    assert state.step == 4
    for name in ("last.pt", "best.pt", "sched_state_last.json",
                 "sched_state_best.json", "ckpt_meta.json", "config.yaml"):
        assert os.path.isfile(os.path.join(run, name)), name
    rows = _rows(run)
    val = [r for r in rows if "val/L1" in r]
    train = [r for r in rows if "model_loss/generator_total_loss" in r]
    assert [r["step"] for r in val] == [2, 4]
    assert [r["step"] for r in train] == [2, 4]
    assert all(np.isfinite(r[k]) for r in train for k in LOSS_KEYS)
    assert all(r["perf/images_per_sec"] > 0 for r in train)
    blob = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    assert blob["step"] == 4 and blob["lr_g"] == pytest.approx(LR)
    assert blob["opt_g"]["state"][0]["step"] == 4

    state = cli.main(argv[:4] + ["--resume", run, "--max-steps", "5",
                                 "--log-every", "2"])
    assert state.step == 5
    assert float(state.opt_d.state_dict()["state"][0]["step"]) == 5
    assert [r["step"] for r in _rows(run) if "val/L1" in r] == [2, 4, 5]


def test_trainer_sigterm_checkpoints_at_the_next_step(tmp_path):
    from nirgan_tpu_torch.data import dataset_selector

    cfg = load_config(_tiny_config_file(tmp_path))
    task = Px2PxTask(cfg, device="cpu")
    trainer = Trainer(task, dataset_selector(cfg), cfg,
                      logdir=str(tmp_path / "run"), max_steps=8)
    trainer._install_preemption_handler = lambda: None
    trainer._preempted = True
    state = trainer.fit()
    assert state.step == 1
    assert torch.load(str(tmp_path / "run" / "last.pt"),
                      weights_only=True)["step"] == 1


@pytest.mark.parametrize("argv,model_name", [
    (["--satclip", "y", "--baseline", "y"], "Linear_NIR"),
    (["--baseline", "y"], "MLP_NIR"),
    (["--satclip", "n", "--baseline", "y"], "CNN_NIR")])
def test_cli_rejects_unported_routes(tmp_path, argv, model_name):
    """Once the refusal of ``--baseline y``, which is ported now: the flag
    (whatever ``--satclip`` says) trains ``BaselineTask`` on a small copy of
    ``configs/config_baselines.yaml`` with each ``model_name``, saves its
    model and no D, and resumes."""
    import yaml

    from nirgan_tpu_torch.tasks import BaselineTask

    cfg = load_config(os.path.join(REPO_ROOT, "configs/config_baselines.yaml")).to_dict()
    cfg["base_configs"]["model_name"] = model_name
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg["Data"].update(train_batch_size=2, val_batch_size=2, num_workers=0)
    cfg["Data"]["fake_settings"].update(image_size=32, length=4)
    cfg["custom_configs"]["Logging"]["num_val_images"] = 1
    path = tmp_path / "baseline.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    run = str(tmp_path / "run")
    common = argv + ["--config", str(path), "--device", "cpu", "--log-every", "1"]
    state = cli.main(common + ["--logdir", run, "--max-steps", "2"])
    assert state.step == 2 and state.opt_d is None
    rows = _rows(run)
    assert [r["step"] for r in rows if "val/L1" in r] == [2]
    train = [r for r in rows if "train/loss" in r]
    assert len(train) == 2 and all(np.isfinite(r["train/L1"]) for r in train)
    blob = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    assert "D" not in blob and "opt_d" not in blob
    names = set(BaselineTask(load_config(str(path)), device="cpu").netG.state_dict())
    assert set(blob["G"]) == names
    state = cli.main(common + ["--resume", run, "--max-steps", "3"])
    assert state.step == 3


def test_weights_only_start_from_a_reference_ckpt(tmp_path, jax_pair):
    """Model.load_weights_only reads a reference Lightning .ckpt (netG.* and
    netD.* keys, as the JAX package exports them) into both networks; an
    entry of another shape is left as it was (strict=False)."""
    from nirgan_tpu.train.torch_convert import (
        export_nlayer_discriminator,
        export_resnet_generator,
    )

    _, _, state = jax_pair
    sd = export_resnet_generator(state.params_g, prefix="netG.", n_blocks=6)
    sd.update(export_nlayer_discriminator(state.params_d, prefix="netD."))
    sd["netD.model.0.bias"] = np.zeros(3, np.float32)  # a wrong shape
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    cfg = load_config(_tiny_config_file(tmp_path))
    cfg.custom_configs.Model.load_weights_only = True
    cfg.custom_configs.Model.weights_path = path
    task = Px2PxTask(cfg, device="cpu", seed=5)
    d0_bias = task.netD.conv0.bias.detach().clone()
    Trainer(task, None, cfg, logdir=str(tmp_path / "run"))._initial_state()
    for net, ref in ((task.netG, params_from_jax(state.params_g)),
                     (task.netD, d_params_from_jax(state.params_d))):
        for k, v in net.state_dict().items():
            want = d0_bias if k == "conv0.bias" and net is task.netD else ref[k]
            torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_resume_from_a_missing_checkpoint_raises(tmp_path):
    cfg = load_config(_tiny_config_file(tmp_path))
    cfg.custom_configs.Model.load_checkpoint = str(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError, match="no 'last' checkpoint"):
        Trainer(Px2PxTask(cfg, device="cpu"), None, cfg)


def test_training_never_imports_jax(tmp_path):
    """The CLI trains two steps on the CPU in a fresh interpreter, and
    neither jax nor any module of the JAX package is among its modules
    afterwards (conftest loads jax here)."""
    cfg = _tiny_config_file(tmp_path)
    code = (
        "import sys\n"
        "from nirgan_tpu_torch.train import cli, trainer\n"
        f"cli.main(['--config', {cfg!r}, '--device', 'cpu', '--max-steps', '2',\n"
        f"          '--logdir', {str(tmp_path / 'run')!r}])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'optax', 'orbax')))\n"
        "assert not bad, bad\n"
        "used = sorted(m for m in sys.modules if m.split('.')[0] == 'nirgan_tpu')\n"
        "assert not used, used\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")
