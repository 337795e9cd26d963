"""The port's baseline regressors and ``BaselineTask`` against the JAX
package, on the CPU in f32 at 32^2, batch 2: each model's forward, one MSE
step and the eval step from the same weights, the serving call, the
reference ``.ckpt`` key map against ``convert_baseline``, the init, and the
training CLI's choice of the baseline config."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config
from nirgan_tpu.models.baselines import build_baseline as jax_build_baseline
from nirgan_tpu.tasks.baseline import BaselineTask as JaxBaselineTask
from nirgan_tpu.train.torch_convert import convert_baseline
from nirgan_tpu_torch import config as port_config
from nirgan_tpu_torch.models.baselines import build_baseline
from nirgan_tpu_torch.tasks import BaselineTask
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.weights import baseline_params_from_jax, load_baseline_weights
from tests.conftest import REPO_ROOT

MODELS = ["Linear_NIR", "MLP_NIR", "CNN_NIR"]
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in tests/test_torch_variants.py: the suite's
    six CPU workers otherwise make small ops wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_name):
    cfg = load_config(os.path.join(REPO_ROOT, "configs/config_baselines.yaml"))
    cfg.base_configs.model_name = model_name
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.random((2, 3, SIZE, SIZE), dtype=np.float32)
    return {"rgb": rgb, "nir": (0.5 * rgb[:, :1] + 0.3 * rgb[:, 2:3]) ** 2}


@pytest.mark.parametrize("model_name", MODELS)
def test_baseline_step_and_eval_match_jax(model_name):
    """One step of each task from the same weights: the loss and the train
    metrics at rtol 2e-5, atol 2e-6 (the fused GAN step's bar); then the
    eval step on another batch with the updated weights (rtol 1e-4: Adam's
    first move of about +-lr on every weight) and the serving call."""
    cfg = _config(model_name)
    jt = JaxBaselineTask(cfg)
    state = jax.device_get(jt.init_state(seed=0, image_size=SIZE))
    port = BaselineTask(cfg, device="cpu")
    port.bind(baseline_params_from_jax(state.params_g))
    batch = _batch(0)
    new, ref = jax.jit(jt.make_train_step())(jax.device_put(state),
                                             jt.extract_batch(batch))
    st = port.init_state()
    got = {k: float(v) for k, v in port.train_step(st, port.extract_batch(batch)).items()}
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    assert set(got) == set(ref) and st.step == 1
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)
    other = _batch(1)
    pred_ref, val_ref = jax.device_get(jt.make_eval_step()(new, jt.extract_batch(other)))
    pred, val = port.eval_step(port.extract_batch(other))
    np.testing.assert_allclose(pred.numpy(), pred_ref, rtol=1e-4, atol=1e-5)
    for k in val_ref:
        np.testing.assert_allclose(float(val[k]), float(val_ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    out = port.predict_step(other["rgb"])
    np.testing.assert_allclose(out, jt.bind(new).predict_step(other["rgb"]),
                               rtol=1e-4, atol=1e-5)
    assert out.shape == (2, 1, SIZE, SIZE)


@pytest.mark.parametrize("model_name", MODELS)
def test_baseline_forward_and_names_match_jax(model_name):
    net = jax_build_baseline(model_name, compute_dtype=jnp.float32)
    params = jax.device_get(net.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3))))
    sd = baseline_params_from_jax(params["params"])
    port = build_baseline(model_name)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 3), dtype=np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("model_name", MODELS)
def test_load_baseline_weights_equals_convert_baseline(tmp_path, model_name):
    """A reference baseline ``.ckpt`` (``linear`` / ``mlp.{0,2,4}``
    ``nn.Linear`` layers, ``net.{0,2,4}`` convs) through the port's key map
    and through ``convert_baseline`` then ``baseline_params_from_jax``: the
    same tensors, bit for bit; it warm-starts the task."""
    rng = np.random.default_rng(5)
    layers = {"Linear_NIR": [("linear", (1, 3))],
              "MLP_NIR": [("mlp.0", (64, 3)), ("mlp.2", (64, 64)), ("mlp.4", (1, 64))],
              "CNN_NIR": [("net.0", (32, 3, 3, 3)), ("net.2", (64, 32, 3, 3)),
                          ("net.4", (1, 64, 3, 3))]}[model_name]
    sd = {}
    for key, shape in layers:
        sd[f"{key}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{key}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    path = str(tmp_path / "baseline.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    got = load_baseline_weights(path, model_name)
    want = baseline_params_from_jax(convert_baseline(sd, model_name))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].is_contiguous() and torch.equal(got[k], v), k
    task = BaselineTask(_config(model_name), device="cpu")
    task.bind(task.load_torch_weights(path)["netG"])
    with pytest.raises(ValueError, match="Invalid Model Name"):
        load_baseline_weights(sd, "UNKNOWN")


def test_baseline_init_is_torch_default():
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases alike,
    seeded."""
    a = build_baseline("CNN_NIR", generator=torch.Generator().manual_seed(4))
    b = build_baseline("CNN_NIR", generator=torch.Generator().manual_seed(4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w, bias = a.conv1.weight, a.conv1.bias
    bound = 1.0 / (32 * 9) ** 0.5
    w, bias = w.detach(), bias.detach()
    assert float(w.abs().max()) <= bound and float(bias.abs().max()) <= bound
    assert abs(float(w.std()) - bound / 3 ** 0.5) < 0.05 * bound
    with pytest.raises(ValueError, match="Invalid Model Name"):
        build_baseline("UNKNOWN")


def test_cli_baseline_flag_takes_the_baseline_config(tmp_path, monkeypatch):
    """``--baseline y`` without ``--config`` loads
    ``configs/config_baselines.yaml`` and trains ``BaselineTask`` (here cut to
    32^2 tiles and batch 2 as it loads)."""
    seen = []
    real_load = port_config.load_config

    def small(path):
        seen.append(path)
        cfg = real_load(os.path.join(REPO_ROOT, path))
        cfg.Data.train_batch_size = cfg.Data.val_batch_size = 2
        cfg.Data.num_workers = 0
        cfg.Data.fake_settings.image_size, cfg.Data.fake_settings.length = SIZE, 4
        cfg.custom_configs.Logging.num_val_images = 0
        return cfg

    monkeypatch.setattr(port_config, "load_config", small)
    state = cli.main(["--baseline", "y", "--device", "cpu", "--max-steps", "2",
                      "--logdir", str(tmp_path / "run")])
    assert seen == ["configs/config_baselines.yaml"]
    assert state.step == 2 and state.opt_d is None
    blob = torch.load(str(tmp_path / "run" / "last.pt"), weights_only=True)
    assert "D" not in blob and set(blob["G"]) == {"linear.weight", "linear.bias"}
