"""The auxiliary generator losses (SSIM, the softmax-CDF histogram proxy and
the spectral-index losses) on the CPU in f32 at a small size: first the JAX
package's own branch of ``make_train_step`` with all three lambdas on, then
the port's losses and its fused step held against it."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nirgan_tpu.losses import RemoteSensingIndices as JaxRemoteSensingIndices
from nirgan_tpu.losses import emd_loss as jax_emd_loss
from nirgan_tpu.losses import gan_loss as jax_gan_loss
from nirgan_tpu.losses import l1_loss as jax_l1_loss
from nirgan_tpu.losses import ssim_loss as jax_ssim_loss
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch.config import save_config
from nirgan_tpu_torch.losses import RemoteSensingIndices, emd_loss, ssim_loss
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.weights import d_params_from_jax, params_from_jax
from tests import test_torch_satclip as satclip_tests
from tests.test_torch_train import (
    SIZE,
    _assert_grads_close,
    _batch,
    _config,
    _port_task,
)

AUX_KEYS = ("model_loss/generator_ssim", "model_loss/generator_hist",
            "model_loss/indices_loss_weighted")
INDICES = ("ndvi", "ndwi", "gndvi", "savi", "msavi", "evi")
# every index weighted, so the weighted sum reaches all six
RS_WEIGHTS = {"lambda_ndvi": 0.3, "lambda_ndwi": 0.2, "lambda_gndvi": 0.1,
              "lambda_savi": 0.15, "lambda_msavi": 0.05, "lambda_evi": 0.2}
# the fused step's: EVI and MSAVI.  The seeded generator's tanh outputs
# reach -0.78, so NDVI's, NDWI's and SAVI's denominators (prediction + R, G
# or R + 0.5) and GNDVI's (NDVI + G) pass through zero on some pixels, where
# the two stacks' 1e-6 differences in the prediction grow to 1e-3 in the
# loss; the unit tests above hold those four on fixed inputs
STEP_WEIGHTS = {"lambda_ndvi": 0.0, "lambda_ndwi": 0.0, "lambda_gndvi": 0.0,
                "lambda_savi": 0.0, "lambda_msavi": 0.4, "lambda_evi": 0.6}


def _aux_config(criterion="l1"):
    cfg = _config()
    bc = cfg.base_configs
    bc.lambda_ssim, bc.lambda_hist, bc.lambda_rs_losses = 2.0, 50.0, 3.0
    bc.rs_losses_criterium = criterion
    bc.internal_rs_loss_weights = dict(STEP_WEIGHTS)
    return cfg


def _fresh(state):
    """A copy of the JAX state for one call of a step that donates it."""
    return jax.tree.map(lambda a: jnp.array(a, copy=True), state)


@pytest.fixture(scope="module")
def aux_pair():
    cfg = _aux_config()
    jt = JaxPx2PxTask(cfg)
    state = jax.device_get(jax.jit(lambda: jt.init_state(seed=0, image_size=SIZE))())
    return cfg, jt, state


def test_jax_step_with_every_auxiliary_loss_runs(aux_pair):
    """Precondition, the JAX package alone: its fused step with lambda_ssim,
    lambda_hist and lambda_rs_losses > 0 (``px2px.py:312-325``, a branch no
    earlier test ran) at ngf 8 and 64^2 gives the three terms, finite, and a
    total that adds them with their lambdas."""
    cfg, jt, state = aux_pair
    _, m = jt.make_train_step()(_fresh(state), jt.extract_batch(_batch(0)))
    m = {k: float(v) for k, v in jax.device_get(m).items()}
    assert all(k in m for k in AUX_KEYS)
    assert all(np.isfinite(m[k]) for k in AUX_KEYS + tuple(LOSS_KEYS))
    bc = cfg.base_configs
    total = (m["model_loss/generator_GAN_loss"] * float(bc.lambda_GAN)
             + m["model_loss/generator_L1"] * float(bc.lambda_L1)
             + m["model_loss/generator_ssim"] * bc.lambda_ssim
             + m["model_loss/generator_hist"] * bc.lambda_hist
             + m["model_loss/indices_loss_weighted"] * bc.lambda_rs_losses)
    np.testing.assert_allclose(m["model_loss/generator_total_loss"], total, rtol=1e-5)


def _images(seed, shape=(2, 24, 20)):
    """rgb (B, H, W, 3), nir and a prediction (B, H, W, 1), reflectance-like
    in (0.02, 0.5), the prediction the NIR plus noise."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.02, 0.5, shape + (3,)).astype(np.float32)
    nir = rng.uniform(0.02, 0.5, shape + (1,)).astype(np.float32)
    pred = np.clip(nir + 0.05 * rng.standard_normal(nir.shape), 0.01, 0.6).astype(np.float32)
    return rgb, nir, pred


@pytest.mark.parametrize("window", [5, 11])
def test_ssim_loss_matches_jax(window):
    _, nir, pred = _images(1)
    ref = float(jax_ssim_loss(jnp.asarray(pred), jnp.asarray(nir), window))
    got = float(ssim_loss(torch.from_numpy(pred), torch.from_numpy(nir), window))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_emd_loss_matches_jax(scale):
    """At reflectance scale and at a scale where the softmax is peaked.  The
    CDFs are f32 running sums of 480 terms, taken in another order by each
    stack: atol 1e-7 on a mean of their differences."""
    _, nir, pred = _images(2)
    ref = float(jax_emd_loss(jnp.asarray(pred * scale), jnp.asarray(nir * scale)))
    got = float(emd_loss(torch.from_numpy(pred * scale), torch.from_numpy(nir * scale)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("criterion", ["l1", "l2"])
@pytest.mark.parametrize("mode", ["loss", "index"])
@pytest.mark.parametrize("index", INDICES)
def test_each_index_matches_jax(index, mode, criterion):
    """Each index in both modes (eps 1e-6 in loss mode, 0 in index mode)
    and both criteria; index mode returns the pair of index images."""
    rgb, nir, pred = _images(3)
    ref = getattr(JaxRemoteSensingIndices(mode, criterion), f"{index}_calculation")(
        jnp.asarray(rgb), jnp.asarray(nir), jnp.asarray(pred))
    got = getattr(RemoteSensingIndices(mode, criterion), f"{index}_calculation")(
        torch.from_numpy(rgb), torch.from_numpy(nir), torch.from_numpy(pred))
    if mode == "loss":
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-7)
    else:
        for g, r in zip(got, ref):
            assert tuple(g.shape) == tuple(r.shape) == (2, 24, 20, 1)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_index_quirks_are_kept():
    """eps only in loss mode (NDVI of a zero pixel: finite in loss mode,
    NaN in index mode), EVI's denominator, a 3-D input batched."""
    rgb = torch.zeros((1, 2, 2, 3))
    nir = torch.zeros((1, 2, 2, 1))
    loss = RemoteSensingIndices("loss").ndvi_calculation(rgb, nir, nir)
    assert float(loss) == 0.0
    idx, _ = RemoteSensingIndices("index").ndvi_calculation(rgb, nir, nir)
    assert bool(torch.isnan(idx).all())
    rgb3, nir3, pred3 = (torch.from_numpy(a[0]) for a in _images(4))
    want = (2.5 * (nir3 - rgb3[..., :1])
            / ((nir3 + 6.0) * (rgb3[..., :1] - 7.5) * (rgb3[..., 2:3] + 1.0)))
    got, _ = RemoteSensingIndices("index").evi_calculation(rgb3, nir3, pred3)
    assert got.shape == (1, 24, 20, 1)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError):
        RemoteSensingIndices("loss", "huber")
    with pytest.raises(AssertionError):
        RemoteSensingIndices("mean")


@pytest.mark.parametrize("criterion", ["l1", "l2"])
@pytest.mark.parametrize("weights", [None, RS_WEIGHTS], ids=["default", "all"])
def test_get_and_weight_losses_matches_jax(criterion, weights):
    """Both modes: the weighted sum (the default weights or all six on),
    and the six ``indices_loss/*`` values of the logging dict within 1e-5
    (relative where GNDVI's near-zero denominators make it large)."""
    rgb, nir, pred = _images(5)
    jr = JaxRemoteSensingIndices("loss", criterion)
    pr = RemoteSensingIndices("loss", criterion)
    args_j = (jnp.asarray(rgb), jnp.asarray(nir), jnp.asarray(pred))
    args_p = (torch.from_numpy(rgb), torch.from_numpy(nir), torch.from_numpy(pred))
    ref = float(jr.get_and_weight_losses(*args_j, loss_config=weights))
    got = float(pr.get_and_weight_losses(*args_p, loss_config=weights))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    ref_d = jr.get_and_weight_losses(*args_j, mode="logging_dict")
    got_d = pr.get_and_weight_losses(*args_p, mode="logging_dict")
    assert set(got_d) == set(ref_d) == {f"indices_loss/{i}_error" for i in INDICES}
    for k in ref_d:
        np.testing.assert_allclose(float(got_d[k]), float(ref_d[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(NotImplementedError):
        pr.get_and_weight_losses(*args_p, mode="dict")


def test_fused_step_with_the_auxiliary_losses_matches_jax(aux_pair):
    """One fused step from the same weights with all three lambdas on: the
    8 + 3 loss terms within rtol 2e-5 + atol 2e-6 of ``make_train_step``'s,
    the bar of the plain step's step 1."""
    cfg, jt, state = aux_pair
    batch = _batch(0)
    _, ref = jt.make_train_step()(_fresh(state), jt.extract_batch(batch))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    port = _port_task(cfg, state)
    got = {k: float(v) for k, v in port.train_step(port.init_state(),
                                                   port.extract_batch(batch)).items()}
    assert set(AUX_KEYS) <= set(got)
    for k in LOSS_KEYS + AUX_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)


def test_step_gradients_with_the_auxiliary_losses_match_jax(aux_pair):
    """G's gradient of the full objective (GAN, L1, SSIM, EMD, indices) and
    D's, against ``jax.grad`` of the same losses from the JAX package's own
    functions, LR 0; each tensor within 1e-4 of its largest entry, the
    biases ahead of a norm as ``_assert_grads_close`` says."""
    cfg, jt, state = aux_pair
    batch = _batch(0)
    ex = jt.extract_batch(batch)
    pg0, pd0 = state.params_g, state.params_d
    rs = JaxRemoteSensingIndices("loss", cfg.base_configs.rs_losses_criterium)

    def g_loss(pg):
        pred = jt.g_apply(pg, ex["rgb"], train=True)
        logits = jt.d_apply(pd0, jnp.concatenate([ex["rgb"], pred], -1))
        return (jax_gan_loss(logits, True, "lsgan") * jt.lambda_gan
                + jax_l1_loss(pred, ex["nir"]) * jt.lambda_l1
                + jax_ssim_loss(pred, ex["nir"]) * jt.lambda_ssim
                + jax_emd_loss(pred, ex["nir"]) * jt.lambda_hist
                + rs.get_and_weight_losses(ex["rgb"][..., :3], ex["nir"], pred,
                                           loss_config=STEP_WEIGHTS) * jt.lambda_rs)

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


def test_concat_route_feeds_the_indices_its_rgb_only():
    """On the concat route the step's input has 4 channels (RGB and the
    embedding plane): the indices take the first 3, as the JAX step does,
    and the step's terms match it."""
    cfg = satclip_tests._config("concat")
    bc = cfg.base_configs
    bc.lambda_rs_losses, bc.rs_losses_criterium = 3.0, "l2"
    bc.internal_rs_loss_weights = dict(STEP_WEIGHTS)
    jt = JaxPx2PxTask(cfg)
    state = jax.device_get(jax.jit(
        lambda: jt.init_state(seed=0, image_size=satclip_tests.SIZE))())
    port = _port_task(cfg, state)
    batch = satclip_tests._batch(0)
    ex = port.extract_batch(batch)
    assert ex["rgb"].shape[-1] == 4
    _, ref = jt.make_train_step()(_fresh(state), jt.extract_batch(batch))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    got = {k: float(v) for k, v in port.train_step(port.init_state(), ex).items()}
    assert "model_loss/generator_ssim" not in got
    for k in LOSS_KEYS + ("model_loss/indices_loss_weighted",):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)


def test_validation_logs_the_index_errors(tmp_path):
    """With lambda_rs_losses > 0 the trainer logs the six
    ``indices_loss/*`` errors of the first validation batch at each
    validation, finite; without it, none."""
    for lam in (3.0, 0.0):
        cfg = _aux_config()
        cfg.base_configs.lambda_rs_losses = lam
        cfg.Data.train_batch_size = 2
        cfg.Data.fake_settings.image_size = 32
        cfg.Data.fake_settings.length = 4
        cfg.Data.num_workers = 0
        path = str(tmp_path / f"cfg_{lam}.yaml")
        save_config(cfg.to_dict(), path)
        run = str(tmp_path / f"run_{lam}")
        # two steps an epoch, a validation at its end
        cli.main(["--config", path, "--device", "cpu", "--max-steps", "2",
                  "--logdir", run])
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        logged = [r for r in rows if "indices_loss/ndvi_error" in r]
        if lam:
            assert logged and all(np.isfinite(r[f"indices_loss/{i}_error"])
                                  for r in logged for i in INDICES)
            assert [r["step"] for r in logged] == [r["step"] for r in rows if "val/L1" in r]
        else:
            assert not logged
