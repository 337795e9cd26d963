"""The port's own copies of the JAX package's jax-free modules (config,
datasets, GeoTIFF codec, host loader, dataset selection, plateau scheduler,
JSONL logger, reference-checkpoint reader) against their originals, on the
same numpy inputs: exact equality throughout."""

import json
import os

import numpy as np
import pytest
import torch

from nirgan_tpu import config as jax_config
from nirgan_tpu.data import datasets as jax_datasets
from nirgan_tpu.data import geotiff as jax_geotiff
from nirgan_tpu.data import pipeline as jax_pipeline
from nirgan_tpu.data import select_dataset as jax_select
from nirgan_tpu.train import scheduler as jax_scheduler
from nirgan_tpu.train.torch_convert import convert_px2px_checkpoint
from nirgan_tpu.utils import loggers as jax_loggers
from nirgan_tpu_torch import config as port_config
from nirgan_tpu_torch.data import datasets as port_datasets
from nirgan_tpu_torch.data import geotiff as port_geotiff
from nirgan_tpu_torch.data import pipeline as port_pipeline
from nirgan_tpu_torch.data import select_dataset as port_select
from nirgan_tpu_torch.train import scheduler as port_scheduler
from nirgan_tpu_torch.utils import loggers as port_loggers
from nirgan_tpu_torch.weights import (
    d_params_from_jax,
    load_reference_weights,
    params_from_jax,
)

CONFIG = "configs/config_px2px.yaml"


def _same_item(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name", ["config_px2px.yaml", "config_px2px_SatCLIP.yaml",
                                  "config_baselines.yaml"])
def test_load_config_equals_the_original(name):
    path = os.path.join("configs", name)
    ours, theirs = port_config.load_config(path), jax_config.load_config(path)
    assert ours.to_dict() == theirs.to_dict()
    assert (port_config.tpu_section(ours).to_dict()
            == jax_config.tpu_section(theirs).to_dict())


def test_save_config_round_trip_equals_the_original(tmp_path):
    cfg = port_config.load_config(CONFIG)
    cfg.base_configs.ngf = 8  # an edit must survive the trip
    port_config.save_config(cfg, str(tmp_path / "port.yaml"))
    jax_config.save_config(jax_config.from_dict(cfg.to_dict()),
                           str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    back = port_config.load_config(str(tmp_path / "port.yaml"))
    assert back.to_dict() == cfg.to_dict() and back.base_configs.ngf == 8
    # each package reads the other's file
    assert (jax_config.load_config(str(tmp_path / "port.yaml")).to_dict()
            == port_config.load_config(str(tmp_path / "jax.yaml")).to_dict())


def test_config_node_behaves_like_the_original():
    for mod in (port_config, jax_config):
        node = mod.from_dict({"a": {"b": 1}, "c": [1, 2]})
        node.a.b = 5
        node["d"] = {"e": 2}
        assert node.a.b == 5 and node.d.e == 2 and "c" in node
        assert node.get("zz", 7) == 7 and len(node) == 3
        merged = mod.merge(node, {"a": {"x": 1}})
        assert merged.to_dict() == {"a": {"b": 5, "x": 1}, "c": [1, 2], "d": {"e": 2}}


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("kwargs", [
    dict(image_size=32, length=5, seed=0),
    dict(image_size=24, length=3, seed=1, return_coords=True),
    dict(image_size=16, length=3, seed=2, mode="geo", return_coords=True),
])
def test_fake_dataset_equals_the_original(kwargs):
    ours = port_datasets.FakeDataset(**kwargs)
    theirs = jax_datasets.FakeDataset(**kwargs)
    assert len(ours) == len(theirs) == kwargs["length"]
    for i in range(len(ours)):
        _same_item(ours[i], theirs[i])


def _write_tiles(root, n=5, size=40):
    rng = np.random.default_rng(0)
    os.makedirs(root)
    for i in range(n):
        img = rng.integers(0, 4000, (4, size, size), dtype=np.uint16)
        if i % 2:
            np.save(os.path.join(root, f"t{i}.npy"), img)
        else:
            np.savez(os.path.join(root, f"t{i}.npz"),
                     rgb=img[:3], nir=img[3:],
                     coords=np.array([10.0 + i, 45.0 - i], np.float32))


@pytest.mark.parametrize("coords", [False, True])
def test_npz_folder_dataset_equals_the_original(tmp_path, coords):
    root = str(tmp_path / "tiles")
    _write_tiles(root)
    ours = port_datasets.NpzFolderDataset(root, image_size=32, return_coords=coords)
    theirs = jax_datasets.NpzFolderDataset(root, image_size=32, return_coords=coords)
    assert ours.files == theirs.files and len(ours) == 5
    for i in range(5):
        _same_item(ours[i], theirs[i])


def test_array_mixed_and_crop_equal_the_original():
    rng = np.random.default_rng(1)
    rgb = rng.random((6, 3, 20, 20), dtype=np.float32)
    nir = rng.random((6, 1, 20, 20), dtype=np.float32)
    np.testing.assert_array_equal(port_datasets.center_crop_chw(rgb[0], 12),
                                  jax_datasets.center_crop_chw(rgb[0], 12))
    pair = []
    for mod in (port_datasets, jax_datasets):
        a = mod.ArrayDataset(rgb[:4], nir[:4])
        b = mod.ArrayDataset(rgb[4:], nir[4:])
        pair.append(mod.MixedDataset([a, b]))
    assert len(pair[0]) == len(pair[1]) == 6
    for i in range(6):
        _same_item(pair[0][i], pair[1][i])


def test_sr_paired_dataset_equals_the_original(tmp_path):
    rng = np.random.default_rng(2)
    for sub, bands, size in (("HR", 3, 32), ("LR", 4, 8)):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            np.savez(tmp_path / sub / f"t{i}.npz",
                     img=rng.integers(0, 3000, (bands, size, size), dtype=np.uint16))
    for passthrough in (False, True):
        ours = port_datasets.SRPairedDataset(str(tmp_path), dn_passthrough=passthrough)
        theirs = jax_datasets.SRPairedDataset(str(tmp_path), dn_passthrough=passthrough)
        assert ours.names == theirs.names and len(ours) == 3
        for i in range(3):
            _same_item(ours[i], theirs[i])


# ----------------------------------------------------------------- geotiff
@pytest.mark.parametrize("kwargs", [
    dict(), dict(deflate=True, predictor=True), dict(compression="lzw"),
    dict(compression="packbits", planar=True),
])
def test_geotiff_written_by_the_original_reads_back_through_the_copy(tmp_path, kwargs):
    img = np.random.default_rng(3).integers(0, 5000, (4, 24, 20), dtype=np.uint16)
    path = str(tmp_path / "a.tif")
    jax_geotiff.write_geotiff(path, img, pixel_scale=(10.0, 10.0),
                              origin=(500000.0, 4649776.0), epsg=32633, **kwargs)
    got, meta = port_geotiff.read_geotiff(path)
    ref, ref_meta = jax_geotiff.read_geotiff(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(port_geotiff.centroid_lonlat(meta),
                                  jax_geotiff.centroid_lonlat(ref_meta))
    # and the other way: the copy writes the same bytes
    port_geotiff.write_geotiff(str(tmp_path / "b.tif"), img, pixel_scale=(10.0, 10.0),
                               origin=(500000.0, 4649776.0), epsg=32633, **kwargs)
    assert (tmp_path / "a.tif").read_bytes() == (tmp_path / "b.tif").read_bytes()


def test_geotiff_folder_dataset_equals_the_original(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(2):
        jax_geotiff.write_geotiff(
            str(tmp_path / f"s{i}.tif"),
            rng.integers(0, 5000, (4, 40, 40), dtype=np.uint16),
            origin=(400000.0 + 1000 * i, 5000000.0), epsg=32632)
    ours = port_datasets.GeoTiffFolderDataset(str(tmp_path), image_size=32,
                                              return_coords=True)
    theirs = jax_datasets.GeoTiffFolderDataset(str(tmp_path), image_size=32,
                                               return_coords=True)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        _same_item(ours[i], theirs[i])


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, seed=3, drop_last=True, num_workers=0),
    dict(shuffle=True, seed=3, drop_last=True, num_workers=2),
    dict(shuffle=False, drop_last=False, num_workers=0),
    dict(shuffle=True, seed=1, drop_last=True, process_index=1, process_count=2),
])
def test_loader_gives_the_same_batches_in_the_same_order(kwargs):
    ds = jax_datasets.FakeDataset(image_size=16, length=11, seed=0,
                                  return_coords=True)
    ours = port_pipeline.Loader(ds, 3, **kwargs)
    theirs = jax_pipeline.Loader(ds, 3, **kwargs)
    assert len(ours) == len(theirs)
    for _ in range(2):  # the second epoch reshuffles alike
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            _same_item(x, y)


def test_collate_equals_the_original():
    items = [{"rgb": np.full((3, 2, 2), i, np.float32), "id": f"t{i}"}
             for i in range(3)]
    ours, theirs = port_pipeline.collate(items), jax_pipeline.collate(items)
    assert ours["id"] == theirs["id"] == ["t0", "t1", "t2"]
    np.testing.assert_array_equal(ours["rgb"], theirs["rgb"])


# --------------------------------------------------------------- selection
@pytest.mark.parametrize("n", [1, 17, 18, 100])
def test_holdout_split_picks_the_same_indices(n):
    ds = list(range(n))
    ours, theirs = port_select._holdout_split(ds), jax_select._holdout_split(ds)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.indices, b.indices)
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]


def test_build_dataset_and_selector_equal_the_original(tmp_path):
    assert port_select._SETTINGS_KEY == jax_select._SETTINGS_KEY
    cfg = port_config.load_config(CONFIG)
    cfg.Data.fake_settings.image_size = 16
    cfg.Data.fake_settings.length = 24
    for split in ("train", "val"):
        ours = port_select.build_dataset("fake", cfg.Data, split)
        theirs = jax_select.build_dataset("fake", cfg.Data, split)
        assert len(ours) == len(theirs)
        _same_item(ours[1], theirs[1])
    with pytest.raises(NotImplementedError, match="not recognised"):
        port_select.build_dataset("nope", cfg.Data)
    # a file-backed type: the held-out split of the selector
    root = str(tmp_path / "tiles")
    _write_tiles(root, n=20, size=16)
    cfg.Data.dataset_type = "S2_rand"
    cfg.Data.S2_rand_settings = {"base_path": root, "image_size": 16}
    cfg.Data.train_batch_size = cfg.Data.val_batch_size = 2
    cfg.Data.num_workers = 0
    ours = port_select.dataset_selector(cfg, seed=4)
    theirs = jax_select.dataset_selector(jax_config.from_dict(cfg.to_dict()), seed=4)
    assert (len(ours.train_ds), len(ours.val_ds)) == (18, 2)
    assert (len(theirs.train_ds), len(theirs.val_ds)) == (18, 2)
    for a, b in zip(ours.train_dataloader(), theirs.train_dataloader()):
        _same_item(a, b)
    for a, b in zip(ours.val_dataloader(), theirs.val_dataloader()):
        _same_item(a, b)
    cfg.Data.native_loader = True
    with pytest.raises(NotImplementedError, match="native_loader"):
        port_select.dataset_selector(cfg)


# --------------------------------------------------------------- scheduler
@pytest.mark.parametrize("kwargs", [
    dict(patience=2), dict(patience=1, mode="max"),
    dict(patience=1, threshold_mode="abs", threshold=0.05, cooldown=1,
         min_lr=1e-5, factor=0.5),
])
def test_plateau_scheduler_gives_the_same_lr_sequence_and_state(kwargs):
    series = [1.0, 0.9, 0.95, 0.94, 0.96, 0.5, 0.51, 0.52, 0.53, 0.54, 0.55]
    ours = port_scheduler.ReduceLROnPlateau(**kwargs)
    theirs = jax_scheduler.ReduceLROnPlateau(**kwargs)
    lr_a = lr_b = 2e-4
    seq_a, seq_b = [], []
    for m in series:
        lr_a, lr_b = ours.step(m, lr_a), theirs.step(m, lr_b)
        seq_a.append(lr_a)
        seq_b.append(lr_b)
        assert vars(ours) == vars(theirs)
    assert seq_a == seq_b and seq_a[-1] < 2e-4
    # the state file is json of the counters: one package reads the other's
    blob = json.loads(json.dumps(vars(theirs)))
    fresh = port_scheduler.ReduceLROnPlateau(**kwargs)
    vars(fresh).update(blob)
    assert fresh.step(0.56, lr_a) == theirs.step(0.56, lr_b)


# ------------------------------------------------------------------ logger
def test_logger_writes_the_same_jsonl_keys(tmp_path):
    metrics = {"train/L1": np.float32(0.25), "model_loss/generator_total_loss": 3.0,
               "val/PSNR": torch.tensor(21.5)}
    ours = port_loggers.ExperimentLogger(str(tmp_path / "port"))
    theirs = jax_loggers.ExperimentLogger(str(tmp_path / "jax"),
                                          use_tensorboard=False, use_wandb=False)
    for step in (1, 2):
        ours.log_metrics(metrics, step)
        theirs.log_metrics(metrics, step)
    ours.close()
    theirs.close()
    rows = [[json.loads(line) for line in open(tmp_path / d / "metrics.jsonl")]
            for d in ("port", "jax")]
    assert len(rows[0]) == len(rows[1]) == 2
    for a, b in zip(*rows):
        assert list(a) == list(b)
        a.pop("time"), b.pop("time")
        assert a == b
    off = port_loggers.ExperimentLogger(str(tmp_path / "off"), enabled=False)
    off.log_metrics(metrics, 1)
    off.close()
    assert not (tmp_path / "off").exists()


# ----------------------------------------------------------------- weights
def _reference_state_dict(n_blocks: int, dropout: bool, towers=("netG", "netD")):
    """Seeded tensors under the reference's ``nn.Sequential`` keys."""
    rng = np.random.default_rng(5)
    sd = {}

    def conv(key, shape):
        sd[f"{key}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{key}.bias"] = rng.standard_normal(shape[0] if "T" not in key
                                                else shape[1]).astype(np.float32)

    if "netG" in towers:
        g, up0 = "netG.model.", 10 + n_blocks
        conv(g + "1", (8, 3, 7, 7))
        conv(g + "4", (16, 8, 3, 3))
        conv(g + "7", (32, 16, 3, 3))
        for i in range(n_blocks):
            conv(f"{g}{10 + i}.conv_block.1", (32, 32, 3, 3))
            conv(f"{g}{10 + i}.conv_block.{6 if dropout else 5}", (32, 32, 3, 3))
        for idx, shape in ((up0, (32, 16, 3, 3)), (up0 + 3, (16, 8, 3, 3))):
            sd[f"{g}{idx}.weight"] = rng.standard_normal(shape).astype(np.float32)
            sd[f"{g}{idx}.bias"] = rng.standard_normal(shape[1]).astype(np.float32)
        conv(g + str(up0 + 7), (1, 8, 7, 7))
    if "netD" in towers:
        d = "netD.model."
        for idx, shape in ((0, (8, 4, 4, 4)), (2, (16, 8, 4, 4)), (5, (32, 16, 4, 4)),
                           (8, (64, 32, 4, 4)), (11, (1, 64, 4, 4))):
            conv(d + str(idx), shape)
    return sd


@pytest.mark.parametrize("netG,dropout,towers", [
    ("resnet_9blocks", False, ("netG", "netD")),
    ("resnet_6blocks", True, ("netG", "netD")),
    ("resnet_9blocks", False, ("netG",)),
    ("resnet_9blocks", False, ("netD",)),
])
def test_load_reference_weights_equals_the_converter_route(tmp_path, netG, dropout,
                                                           towers):
    """The port's direct key map against the old detour through the flax
    layouts (``convert_px2px_checkpoint`` then ``params_from_jax`` /
    ``d_params_from_jax``): the same keys, bit for bit."""
    cfg = port_config.load_config(CONFIG)
    cfg.base_configs.netG = netG
    cfg.base_configs.no_dropout = not dropout
    sd = _reference_state_dict(9 if netG == "resnet_9blocks" else 6, dropout, towers)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 3}, path)
    got = load_reference_weights(path, cfg)
    old = convert_px2px_checkpoint(path, jax_config.from_dict(cfg.to_dict()))
    want = {}
    if "params_g" in old:
        want["netG"] = params_from_jax(old["params_g"])
    if "params_d" in old:
        want["netD"] = d_params_from_jax(old["params_d"])
    assert sorted(got) == sorted(want) == sorted(towers)
    for tower in want:
        assert list(got[tower]) == list(want[tower]), tower
        for k, v in want[tower].items():
            assert got[tower][k].dtype == v.dtype == torch.float32
            assert got[tower][k].is_contiguous()
            assert torch.equal(got[tower][k], v), (tower, k)


@pytest.mark.parametrize("edit,error,message", [
    (lambda c, sd: setattr(c.base_configs, "netG", "unet_256"),
     NotImplementedError, "U-Net"),
    (lambda c, sd: setattr(c.base_configs, "netD", "pixel"),
     NotImplementedError, "pixel"),
])
def test_load_reference_weights_raises_on_what_is_not_ported(edit, error, message):
    cfg = port_config.load_config(CONFIG)
    sd = _reference_state_dict(9, False)
    edit(cfg, sd)
    with pytest.raises(error, match=message):
        load_reference_weights(sd, cfg)
