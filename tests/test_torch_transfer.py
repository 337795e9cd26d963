"""``tpu.transfer_dtype`` and ``tpu.debug_nans`` in the port against the JAX
package, on the CPU at a small size: ``configs/ab_geo_plain.yaml`` (which
sets ``transfer_dtype: float16``) shrunk as the train tests shrink
``config_px2px.yaml``: its ``extract_batch`` and one fused step against
the JAX task's; DN integers and the SatCLIP embeddings untouched by the
cast; a non-finite step raising under ``debug_nans``."""

import os

import numpy as np
import pytest
import torch

import jax

from nirgan_tpu.config import load_config
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch.tasks import BaselineTask, Px2PxTask
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
from tests.conftest import REPO_ROOT
from tests.test_torch_train import PAD, SIZE, _batch, _port_task


def _config(name="ab_geo_plain.yaml"):
    cfg = load_config(os.path.join(REPO_ROOT, "configs", name))
    bc = cfg.base_configs
    bc.netG, bc.ngf, bc.ndf = "resnet_6blocks", 8, 8
    cfg.Data.padding_amount = PAD
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.shape_buckets = [SIZE]
    return cfg


@pytest.fixture(scope="module")
def jax_pair():
    cfg = _config()
    assert cfg.tpu.transfer_dtype == "float16"
    jt = JaxPx2PxTask(cfg)
    state = jax.jit(lambda: jt.init_state(seed=0, image_size=SIZE))()
    return cfg, jt, jax.device_get(state)


def test_extract_batch_casts_float_inputs_as_jax(jax_pair):
    """Float rgb and nir reach the device in f16, the values JAX's
    ``extract_batch`` holds bit for bit; the step widens them."""
    cfg, jt, state = jax_pair
    port = Px2PxTask(cfg, device="cpu", seed=0)
    batch = _batch(0)
    ref = jt.extract_batch(batch)
    got = port.extract_batch(batch)
    for k in ("rgb", "nir"):
        assert got[k].dtype == torch.float16 and ref[k].dtype == np.float16, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert port._dn_to_reflectance(got["rgb"], torch.float32).dtype == torch.float32
    # the same batch without the key stays f32 and differs by the rounding
    cfg32 = _config()
    cfg32.tpu.transfer_dtype = None
    plain = Px2PxTask(cfg32, device="cpu", seed=0).extract_batch(batch)
    assert plain["rgb"].dtype == torch.float32
    assert not torch.equal(plain["rgb"], got["rgb"].float())


def test_dn_integers_and_embeddings_keep_their_dtype():
    """uint16 DN pass through as integers; the inject route's embeddings
    are f32 (the JAX task casts only the float rgb and nir)."""
    cfg = _config("ab_geo_satclip.yaml")
    cfg.base_configs.netG = "resnet_9blocks"  # the inject generator's
    cfg.satclip.satclip_path = None
    assert cfg.tpu.transfer_dtype == "float16"
    port = Px2PxTask(cfg, device="cpu", seed=0)
    dn = np.random.default_rng(1).integers(0, 10000, (2, 3, 16, 16), np.uint16)
    ex = port.extract_batch({"rgb": dn, "nir": dn[:, :1],
                             "coords": np.asarray([[9.0, 48.0], [-120.0, 35.0]])})
    assert ex["rgb"].dtype == torch.uint16 and ex["nir"].dtype == torch.uint16
    assert ex["embeds"].dtype == torch.float32


def test_step_under_transfer_dtype_matches_jax(jax_pair):
    """One fused step of the shrunk ``ab_geo_plain.yaml`` (f16 transfer):
    the 8 loss terms against the JAX step's within rtol 2e-5, atol 2e-6,
    the bar of ``test_fused_step_loss_terms_match_jax``'s first step."""
    cfg, jt, state = jax_pair
    port = _port_task(cfg, state)
    batch = _batch(0)
    _, ref = jt.make_train_step()(jax.device_put(state), jt.extract_batch(batch))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    got = {k: float(v) for k, v in
           port.train_step(port.init_state(), port.extract_batch(batch)).items()}
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)


def test_debug_nans_raises_on_a_non_finite_step(jax_pair):
    """With ``debug_nans`` a step whose loss is not finite raises
    ``FloatingPointError`` before any update; without the key it returns the
    NaN loss (the JAX trainer's ``jax_debug_nans`` and its absence)."""
    cfg, _, _ = jax_pair
    batch = _batch(0)
    batch["nir"] = batch["nir"].copy()
    batch["nir"][0, 0, 0, 0] = np.nan
    quiet = Px2PxTask(cfg, device="cpu", seed=0)
    terms = quiet.train_step(quiet.init_state(), quiet.extract_batch(batch))
    assert not np.isfinite(float(terms["model_loss/generator_L1"]))
    cfg.tpu.debug_nans = True
    try:
        task = Px2PxTask(cfg, device="cpu", seed=0)
        before = {k: v.clone() for k, v in task.netD.state_dict().items()}
        with pytest.raises(FloatingPointError, match="debug_nans"):
            task.train_step(task.init_state(), task.extract_batch(batch))
        assert all(torch.equal(before[k], v) for k, v in task.netD.state_dict().items())
        base = load_config(os.path.join(REPO_ROOT, "configs", "config_baselines.yaml"))
        base.tpu.compute_dtype, base.tpu.debug_nans = "float32", True
        model = BaselineTask(base, device="cpu", seed=0)
        with pytest.raises(FloatingPointError, match="debug_nans"):
            model.train_step(model.init_state(), model.extract_batch(batch))
    finally:
        cfg.tpu.debug_nans = False
