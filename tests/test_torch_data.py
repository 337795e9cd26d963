"""The port's own copies of the JAX package's jax-free modules (config,
datasets, GeoTIFF codec, host loader, dataset selection, plateau scheduler,
JSONL logger, reference-checkpoint reader, the S2Geo pretraining data and
the positional encodings) against their originals, on the same numpy
inputs: exact equality throughout."""

import json
import os

import numpy as np
import pytest
import torch

from nirgan_tpu import config as jax_config
from nirgan_tpu.data import datasets as jax_datasets
from nirgan_tpu.data import geotiff as jax_geotiff
from nirgan_tpu.data import pipeline as jax_pipeline
from nirgan_tpu.data import s2geo as jax_s2geo
from nirgan_tpu.data import select_dataset as jax_select
from nirgan_tpu.models.satclip import positional_encoding as jax_posenc
from nirgan_tpu.train import scheduler as jax_scheduler
from nirgan_tpu.train.torch_convert import convert_px2px_checkpoint
from nirgan_tpu.utils import loggers as jax_loggers
from nirgan_tpu_torch import config as port_config
from nirgan_tpu_torch.data import datasets as port_datasets
from nirgan_tpu_torch.data import geotiff as port_geotiff
from nirgan_tpu_torch.data import pipeline as port_pipeline
from nirgan_tpu_torch.data import s2geo as port_s2geo
from nirgan_tpu_torch.data import select_dataset as port_select
from nirgan_tpu_torch.models.satclip import positional_encoding as port_posenc
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


def _norm_source(name: str) -> str:
    """The port's conv that feeds the norm ``name``."""
    head, _, last = name.rpartition(".")
    prefix = head + "." if head else ""
    table = {"n0": "c0", "nd0": "d0", "nd1": "d1", "nu0": "u0", "nu1": "u1",
             "downnorm": "down", "upnorm": "up"}
    if last in table:
        return prefix + table[last]
    return prefix + last.replace("norm", "conv")


@pytest.mark.parametrize("netG,netD,dropout", [
    ("unet_128", "basic", False),
    ("resnet_6blocks", "pixel", True),
])
def test_load_reference_weights_raises_on_what_is_not_ported(netG, netD, dropout):
    """Once the U-Net's and the pixel D's refusals, both are ported now: a
    reference state_dict of batch-norm nets (the convs as the JAX package's
    ``export_*`` write them, each batch norm at the index after its conv's,
    with its buffers) reads into the port as ``params_from_jax`` maps the
    JAX trees, bit for bit; the convs also as ``convert_px2px_checkpoint``
    reads them, and the norms as ``_bn_split`` does; both load strictly."""
    import jax
    import jax.numpy as jnp

    from nirgan_tpu.models.factory import define_D as jax_define_D
    from nirgan_tpu.models.factory import define_G as jax_define_G
    from nirgan_tpu.train import torch_convert as tc
    from nirgan_tpu_torch.models import define_D, define_G
    from tests.test_torch_variants import _fill

    cfg = port_config.load_config(CONFIG)
    bc = cfg.base_configs
    bc.netG, bc.netD, bc.norm, bc.ngf, bc.ndf = netG, netD, "batch", 8, 8
    bc.no_dropout = not dropout
    side = 128 if netG == "unet_128" else 32

    def tree(net, x_shape, seed):
        return _fill(jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                                     jnp.zeros(x_shape))), seed)

    vg = tree(jax_define_G(3, 1, 8, netG, norm="batch", use_dropout=dropout),
              (1, side, side, 3), 1)
    vd = tree(jax_define_D(4, 8, netD, norm="batch"), (1, 32, 32, 4), 2)
    sd = (tc.export_unet_generator(vg["params"], "netG.", 7) if netG == "unet_128"
          else tc.export_resnet_generator(vg["params"], "netG.", 6, dropout))
    sd.update(tc.export_pixel_discriminator(vd["params"], "netD.") if netD == "pixel"
              else tc.export_nlayer_discriminator(vd["params"], "netD."))
    want = {"netG": params_from_jax(vg["params"], vg["batch_stats"]),
            "netD": d_params_from_jax(vd["params"], vd["batch_stats"])}
    refs = {}
    for tower, prefix in (("netG", "netG."), ("netD", "netD.")):
        for name in want[tower]:
            if name.endswith(".running_mean"):
                norm = name[:-len(".running_mean")]
                conv = want[tower][f"{_norm_source(norm)}.weight"].numpy()
                key = next(k for k, v in sd.items() if k.startswith(prefix)
                           and k.endswith(".weight") and np.array_equal(v, conv))
                head, _, idx = key[:-len(".weight")].rpartition(".")
                ref = f"{head}.{int(idx) + 1}"
                for field in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{ref}.{field}"] = want[tower][f"{norm}.{field}"].numpy()
                sd[f"{ref}.num_batches_tracked"] = np.array(0, np.int64)
                refs[(tower, norm)] = ref
    got = load_reference_weights(sd, cfg)
    old = convert_px2px_checkpoint(sd, jax_config.from_dict(cfg.to_dict()))
    convs = {"netG": params_from_jax(old["params_g"]),
             "netD": d_params_from_jax(old["params_d"])}
    assert sorted(got) == ["netD", "netG"]
    for tower in want:
        assert sorted(got[tower]) == sorted(want[tower]), tower
        for k, v in want[tower].items():
            assert torch.equal(got[tower][k], v), (tower, k)
        for k, v in convs[tower].items():
            assert torch.equal(got[tower][k], v), (tower, k)
    for (tower, norm), ref in refs.items():
        params, stats = tc._bn_split(sd, ref)
        for field, value in (("weight", params["scale"]), ("bias", params["bias"]),
                             ("running_mean", stats["mean"]),
                             ("running_var", stats["var"])):
            np.testing.assert_array_equal(got[tower][f"{norm}.{field}"].numpy(), value)
    assert len(refs) > 3
    define_G(3, 1, 8, netG, "batch", use_dropout=dropout).load_state_dict(
        got["netG"], strict=True)
    define_D(4, 8, netD, norm="batch").load_state_dict(got["netD"], strict=True)


# ------------------------------------------------------------ S2Geo data
@pytest.mark.parametrize("kwargs", [
    dict(length=5, crop=16, channels=4, mode="rand"),
    dict(length=5, crop=16, channels=4, mode="geo", seed=3),
    dict(length=3, crop=24, channels=13, mode="geo"),
    dict(length=3, crop=16, channels=4, mode="geo", augment=False),
])
def test_fake_s2geo_dataset_equals_the_original(kwargs):
    ours = port_s2geo.FakeS2GeoDataset(**kwargs)
    theirs = jax_s2geo.FakeS2GeoDataset(**kwargs)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        _same_item(ours[i], theirs[i])


def _write_s2geo_tiles(root, n=7, size=40):
    rng = np.random.default_rng(17)
    os.makedirs(root)
    for i in range(n):
        key = "point" if i % 2 else "coords"
        np.savez(os.path.join(root, f"t{i}.npz"),
                 image=rng.integers(0, 10000, (4, size, size)).astype(np.uint16),
                 **{key: rng.uniform(-90, 90, 2).astype(np.float32)})


@pytest.mark.parametrize("augment", [True, False])
def test_s2geo_folder_packing_and_packed_reader_equal_the_original(tmp_path, augment):
    src = str(tmp_path / "tiles")
    _write_s2geo_tiles(src)
    ours = port_s2geo.S2GeoDataset(src, crop=32, seed=3, augment=augment)
    theirs = jax_s2geo.S2GeoDataset(src, crop=32, seed=3, augment=augment)
    for i in range(len(ours)):
        _same_item(ours[i], theirs[i])
    n_ours = port_s2geo.pack_s2geo_shards(
        port_s2geo.S2GeoDataset(src, augment=False, crop=1 << 30),
        str(tmp_path / "ours"), tiles_per_shard=3)
    n_theirs = jax_s2geo.pack_s2geo_shards(
        jax_s2geo.S2GeoDataset(src, augment=False, crop=1 << 30),
        str(tmp_path / "theirs"), tiles_per_shard=3)
    assert n_ours == n_theirs == 3
    for f in sorted(os.listdir(tmp_path / "theirs")):
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / f),
                                      np.load(tmp_path / "theirs" / f), err_msg=f)
    packed = port_s2geo.PackedS2GeoDataset(str(tmp_path / "ours"), crop=32, seed=3,
                                           augment=augment)
    ref = jax_s2geo.PackedS2GeoDataset(str(tmp_path / "theirs"), crop=32, seed=3,
                                       augment=augment)
    assert len(packed) == len(ref) == 7
    for i in range(7):
        _same_item(packed[i], ref[i])
    a = next(iter(port_s2geo.S2GeoDataModule(base_path=str(tmp_path / "ours"),
                                             batch_size=2, crop=32,
                                             num_workers=0).train_dataloader()))
    b = next(iter(jax_s2geo.S2GeoDataModule(base_path=str(tmp_path / "theirs"),
                                            batch_size=2, crop=32,
                                            num_workers=0).train_dataloader()))
    _same_item(a, b)


def test_s2geo_train_transform_equals_the_original():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    img = np.random.default_rng(0).random((4, 48, 48), dtype=np.float32)
    item = {"image": img, "point": np.asarray([10.0, -20.0], np.float32)}
    for _ in range(4):  # crops, flips and blurs from the same stream
        _same_item(port_s2geo.train_transform(dict(item), rng_a, crop=32, blur_p=0.7),
                   jax_s2geo.train_transform(dict(item), rng_b, crop=32, blur_p=0.7))


# ---------------------------------------------------- positional encodings
@pytest.mark.parametrize("name", ["theory", "grid", "spherec", "spherecplus",
                                  "spherem", "spheremplus"])
def test_positional_encoding_ladders_equal_the_original(name):
    """The copies build the same frequency ladder and width; their values
    are held to the originals' in ``test_torch_satclip_pretrain.py``."""
    kw = dict(min_radius=0.5, max_radius=90, frequency_num=7)
    ours = port_posenc.get_positional_encoding(name, **kw)
    theirs = jax_posenc.get_positional_encoding(name, **kw)
    assert ours.embedding_dim == theirs.embedding_dim
    np.testing.assert_array_equal(ours.freq_list, theirs.freq_list)
    assert port_posenc.__all__ == jax_posenc.__all__
