"""The port's training route on 512^2 tiles, the configuration of the
reference's Sentinel-2 datasets (``S2_75k_settings`` / ``S2_100k_settings``,
``configs/config_px2px.yaml:39-48``: 512^2 tiles, reflect-padded to 532^2,
batch 16), on the CPU:

- the launch plans of kernels B, B4, B5, A and C at every shape of the
  532^2 step at batch 16 in bf16 (and of the f32 step at batch 2), which
  are shape-only: each exists, raises nothing, and stays inside what its
  kernel takes (the regimes, the split-K slabs, the 32-bit pixel counts);
- seeded uint16 RGBN ``.npy`` tiles of 512^2 through the port's and the
  JAX package's ``S2_75k`` datasets and ``extract_batch`` to equal batches,
  the generator's input at 532^2;
- one f32 step at ``image_size: 512`` and tiny widths (ngf 4, ndf 4,
  ``resnet_6blocks``, batch 1) against the JAX step, within
  ``tests/test_torch_train.py``'s step-1 bound.

The kernels themselves run on the card only (``chip_smoke.py --phase
train512``)."""

import os

import numpy as np
import pytest
import torch

import jax

from nirgan_tpu.config import load_config as jax_load_config
from nirgan_tpu.data import dataset_selector as jax_dataset_selector
from nirgan_tpu.ops.pad import reflect_pad2d as jax_reflect_pad2d
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu.train.state import create_state
from nirgan_tpu_torch.config import load_config
from nirgan_tpu_torch.data import dataset_selector
from nirgan_tpu_torch.ops import convt_bwd, head_conv, instance_norm, trunk_conv
from nirgan_tpu_torch.ops.pad import reflect_pad2d
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
from nirgan_tpu_torch.weights import d_params_from_jax, params_from_jax
from tests.conftest import REPO_ROOT

TILE, PAD, BATCH = 512, 10, 16
SIDE = TILE + 2 * PAD  # 532
SMS = 132  # an H100 SXM's SMs
# the instance norm's shapes in the 532^2 step: G at 532^2, 266^2, 133^2;
# the PatchGAN on 512^2 at 128^2, 64^2, 63^2
NORM_SHAPES = [(SIDE, 64), (SIDE // 2, 128), (SIDE // 4, 256), (TILE // 4, 128),
               (TILE // 8, 256), (TILE // 8 - 1, 512)]
# (batch, itemsize): the bf16 step at batch 16, the f32 step at batch 2
STEPS = [(BATCH, 2), (2, 4)]


def _config(folder: str, **data):
    """``config_px2px.yaml`` with ``dataset_type: S2_75k`` on ``folder``,
    through either package's loader."""
    out = []
    for load in (load_config, jax_load_config):
        cfg = load(os.path.join(REPO_ROOT, "configs/config_px2px.yaml"))
        cfg.Data.dataset_type = "S2_75k"
        cfg.Data.S2_75k_settings.base_path = folder
        cfg.Data.num_workers = 0
        for key, value in data.items():
            cfg.Data[key] = value
        out.append(cfg)
    return out


def _tiles(folder, n: int, seed: int = 0) -> None:
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(os.path.join(folder, f"s2_{i:03d}.npy"),
                rng.integers(0, 10000, (4, TILE, TILE), dtype=np.uint16))


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("backward", [False, True], ids=["B", "B4"])
@pytest.mark.parametrize("batch,itemsize", STEPS, ids=["bf16_b16", "f32_b2"])
@pytest.mark.parametrize("side,c", NORM_SHAPES, ids=[f"{s}x{c}" for s, c in NORM_SHAPES])
def test_norm_plans_at_the_532_step(side, c, batch, itemsize, backward):
    """B's and B4's plan at each norm shape of the step: a resident plan's
    cluster holds the slab within a block's shared memory; a streaming
    plan's slabs are 1 to 128, none empty, and its scratch (B, slabs, 4, C)
    f32.  At 532^2 and 266^2 (G's streaming shapes, 3.7x the 276^2 step's
    largest) both directions stream in bf16."""
    hw = side * side
    plan = instance_norm.launch_plan(batch, hw, c, itemsize, backward)
    if plan.regime == "resident":
        assert plan.smem_bytes <= instance_norm.MAX_SMEM
        assert plan.cluster in (1, 2, 4, 8) and plan.slabs == plan.cluster
        rows = -(-hw // plan.cluster)
        per_pixel = plan.group * itemsize * (2 if backward else 1)
        assert plan.smem_bytes >= rows * per_pixel
    else:
        assert plan.regime == "streaming" and 1 <= plan.slabs <= 128
        rows = -(-hw // plan.slabs)
        assert rows * (plan.slabs - 1) < hw
        assert c % plan.group == 0 or plan.group == c
    if side in (SIDE, SIDE // 2) and itemsize == 2:
        assert plan.regime == "streaming"
    # every offset is 64-bit in the kernels; a pixel index a 32-bit int
    assert batch * hw < 2 ** 31


@pytest.mark.parametrize("layer,hi,ci,co", [("u1", SIDE // 2, 128, 64),
                                            ("u0", SIDE // 4, 256, 128)])
@pytest.mark.parametrize("batch,dtype", [(BATCH, torch.bfloat16), (2, torch.float32)],
                         ids=["bf16_b16", "f32_b2"])
def test_convt_bwd_plans_at_the_532_step(layer, hi, ci, co, batch, dtype):
    """B5's plan at u1 (z (16, 266^2, 128) -> ct (16, 532^2, 64), 1.13 M
    pixels) and u0: the wgmma kernels in bf16, dW split over slabs that
    cover every pixel, none empty, each a multiple of 64 pixels on the
    wgmma kernel."""
    packed, slabs, slab = convt_bwd.launch_plan(
        dtype, (batch, hi, hi, ci), (batch, 2 * hi, 2 * hi, co), (ci, co, 3, 3))
    m = batch * hi * hi
    assert packed == (dtype == torch.bfloat16)
    assert slabs * slab >= m > (slabs - 1) * slab
    if packed:
        assert slab % 64 == 0
    assert m < 2 ** 31


@pytest.mark.parametrize("batch,dtype", [(BATCH, torch.bfloat16), (2, torch.float32)],
                         ids=["bf16_b16", "f32_b2"])
@pytest.mark.parametrize("pad", [1, 0])
def test_trunk_plan_at_the_532_step(batch, dtype, pad):
    """A at (16, 133^2, 256) in both pad modes: the wgmma kernel in bf16."""
    side = SIDE // 4 + 2 * (1 - pad)
    ho, wo, packed = trunk_conv.launch_plan(dtype, (batch, side, side, 256),
                                            (256, 256, 3, 3), pad)
    assert (ho, wo) == (SIDE // 4, SIDE // 4)
    assert packed == (dtype == torch.bfloat16)


@pytest.mark.parametrize("batch", [BATCH, 2])
def test_head_plan_at_the_532_step(batch):
    """C at (16, 538^2, 64): the mma kernel's runs of rows and its grid."""
    ho = wo = SIDE
    rows = head_conv.launch_plan(batch, ho, wo, SMS)
    strips = -(-wo // head_conv.STRIP)
    blocks = batch * strips * -(-ho // (2 * rows))
    assert 0 < rows <= ho and 0 < blocks < 2 ** 31


# ------------------------------------------------------------ data
def test_s2_batches_match_jax(tmp_path):
    """Seeded uint16 RGBN tiles of 512^2 through both packages' ``S2_75k``
    datasets (every 17th held out for validation): the items, the first
    shuffled train batch and the first val batch equal, as are
    ``extract_batch``'s batches and the generator's input, reflect-padded
    to 532^2."""
    folder = str(tmp_path / "s2")
    _tiles(folder, 18)
    cfg, jcfg = _config(folder, train_batch_size=2, val_batch_size=2)
    dm, jdm = dataset_selector(cfg, seed=0), jax_dataset_selector(jcfg, seed=0)
    assert len(dm.train_ds) == len(jdm.train_ds) == 16
    assert len(dm.val_ds) == len(jdm.val_ds) == 2
    item, jitem = dm.train_ds[3], jdm.train_ds[3]
    for k in ("rgb", "nir"):
        np.testing.assert_array_equal(item[k], jitem[k])
    task, jtask = Px2PxTask(cfg, device="cpu"), JaxPx2PxTask(jcfg)
    for got, ref in ((next(iter(dm.train_dataloader())), next(iter(jdm.train_dataloader()))),
                     (next(iter(dm.val_dataloader())), next(iter(jdm.val_dataloader())))):
        assert got["rgb"].shape == (2, 3, TILE, TILE)
        np.testing.assert_array_equal(got["rgb"], ref["rgb"])
        np.testing.assert_array_equal(got["nir"], ref["nir"])
        ex, jex = task.extract_batch(got), jtask.extract_batch(ref)
        for k in ("rgb", "nir"):
            np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]))
        x = reflect_pad2d(ex["rgb"], task.pad_amount)
        assert tuple(x.shape) == (2, SIDE, SIDE, 3)
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(jax_reflect_pad2d(jex["rgb"], jtask.pad_amount)))


# ------------------------------------------------------------ one step
def test_f32_step_at_512_matches_jax(tmp_path):
    """One fused f32 step at ``image_size: 512`` (ngf 4, ndf 4,
    ``resnet_6blocks``, batch 1, pad 10: the generator at 532^2, the
    PatchGAN on 512^2) from the JAX state's weights, on a tile of the
    ``S2_75k`` folder: the eight loss terms within rtol 2e-5, atol 2e-6 of
    the JAX step's (``tests/test_torch_train.py``'s step 1)."""
    folder = str(tmp_path / "s2")
    _tiles(folder, 2, seed=1)
    cfg, jcfg = _config(folder, train_batch_size=1)
    for c in (cfg, jcfg):
        c.base_configs.netG, c.base_configs.ngf, c.base_configs.ndf = "resnet_6blocks", 4, 4
        c.tpu.compute_dtype = "float32"
        c.tpu.shape_buckets = [TILE]
    batch = next(iter(dataset_selector(cfg, seed=0).train_dataloader()))
    assert batch["rgb"].shape == (1, 3, TILE, TILE)
    jt = JaxPx2PxTask(jcfg)
    # the parameters in the shapes of the JAX init (eager flax would
    # compile each operation anew), drawn with numpy: N(0, 0.02), as the
    # normal init
    shapes = jax.eval_shape(lambda: jt.init_state(seed=0, image_size=32))
    rng = np.random.default_rng(2)

    def draw(tree):
        return jax.tree_util.tree_map(
            lambda v: (rng.standard_normal(v.shape) * 0.02).astype(np.float32), tree)

    state = jax.device_get(create_state(jax.random.key(0), draw(shapes.params_g),
                                        draw(shapes.params_d), lr=float(jcfg.base_configs.lr),
                                        beta1=float(jcfg.base_configs.beta1)))
    _, ref = jt.make_train_step()(jax.device_put(state), jt.extract_batch(batch))
    ref = {k: float(v) for k, v in jax.device_get(ref).items()}
    task = Px2PxTask(cfg, device="cpu", seed=0)
    task.netG.load_state_dict(params_from_jax(state.params_g), strict=True)
    task.netD.load_state_dict(d_params_from_jax(state.params_d), strict=True)
    seen = []
    task.netG.register_forward_pre_hook(lambda m, args: seen.append(tuple(args[0].shape)))
    got = task.train_step(task.init_state(), task.extract_batch(batch))
    assert seen[0] == (1, SIDE, SIDE, 3)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), ref[k], rtol=2e-5, atol=2e-6, err_msg=k)
    assert np.isfinite([float(got[k]) for k in LOSS_KEYS]).all()
    assert ref["model_loss/generator_L1"] > 0
