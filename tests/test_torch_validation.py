"""The port's validation tools against the JAX package's, on the CPU: the
per-sample metric program, the crop, the geo joins and shipped layers, the
GeoJSON writer, the spider sweep, ``create_val_metrics`` from a reference
``.ckpt`` and from a run of the port's trainer, the radar comparison, the
time series, the CLC panels, the validation CLI, and the trainer's
``save_val_df`` sweep (training bit for bit as without it; the int8 pack
rebuilt for each sweep).

Tolerances: the metric program rtol 1e-5 (f32, the same formulas); the
sweep's metric columns atol 2e-5, the generator-parity bound of the port's
serving tests (f32); groups, joins, files and copies exactly."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from nirgan_tpu.config import load_config as jax_load_config
from nirgan_tpu.data.datasets import FakeDataset
from nirgan_tpu.data.geotiff import write_geotiff
from nirgan_tpu.data.select_dataset import dataset_selector as jax_dataset_selector
from nirgan_tpu.models.factory import define_G as jax_define_G
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu.train.torch_convert import export_px2px_checkpoint
from nirgan_tpu.utils import logging_helpers as jax_helpers
from nirgan_tpu.utils import plot_clc as jax_plot_clc
from nirgan_tpu.validation import geo_ablation as jax_geo
from nirgan_tpu.validation import layers as jax_layers
from nirgan_tpu.validation import results_table as jax_results
from nirgan_tpu.validation import time_series as jax_ts
from nirgan_tpu.validation.per_sample_metrics import per_sample_metrics as jax_psm
from nirgan_tpu.validation.spider import spider_validation_callback as jax_spider
from nirgan_tpu.validation.val_utils import crop_center as jax_crop
from nirgan_tpu_torch import validate
from nirgan_tpu_torch.config import load_config
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.train import cli
from nirgan_tpu_torch.train.checkpoint import CheckpointManager
from nirgan_tpu_torch.utils import logging_helpers, plot_clc
from nirgan_tpu_torch.validation import geo_ablation, layers, results_table, spiders
from nirgan_tpu_torch.validation import time_series
from nirgan_tpu_torch.validation.per_sample_metrics import per_sample_metrics
from nirgan_tpu_torch.validation.spider import METRIC_COLUMNS, spider_validation_callback
from nirgan_tpu_torch.validation.val_utils import crop_center
from nirgan_tpu_torch.weights import params_from_jax
from tests.conftest import REPO_ROOT

SIZE = 32
GROUPS = ["Country", "Continent", "economy", "Koppen_Class"]
ATOL = 2e-5  # the f32 generator-parity bound of the port's serving tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_config(tmp_path, name="config_px2px.yaml", **experimentation):
    """A small copy of a shipped config as a file: ngf 8, 6 blocks (the
    inject route keeps its 9), f32, 32² tiles with coordinates, 8 val
    samples, 2 steps an epoch."""
    cfg = yaml.safe_load(open(os.path.join(REPO_ROOT, "configs", name)))
    bc = cfg["base_configs"]
    bc.update(ngf=8, ndf=8)
    if "satclip" not in name.lower():
        bc["netG"] = "resnet_6blocks"
    else:
        cfg["satclip"]["satclip_path"] = None
    cfg["Data"].update(padding_amount=2, train_batch_size=2, val_batch_size=2,
                       num_workers=0)
    cfg["Data"]["fake_settings"].update(image_size=SIZE, length=4, return_coords=True)
    cfg["tpu"].update(compute_dtype="float32", shape_buckets=[SIZE])
    cfg["custom_configs"]["experimentation"] = {"save_val_df": False,
                                                **experimentation}
    path = tmp_path / f"small_{name}"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _positive_params():
    """Seeded params (N(0, 0.02), in the shapes ``jax.eval_shape`` gives:
    no compile) of the small config's generator, whose head gives NIR in
    about (0.7, 0.8), as a trained generator's lies in (0, 1): the spectral
    indices of a random generator's negative output sit near their poles,
    where the f32 generator bound says nothing about them."""
    net = jax_define_G(3, 1, 8, "resnet_6blocks", norm="instance")
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(
        lambda sd: 0.02 * rng.standard_normal(sd.shape).astype(np.float32),
        shapes)["params"]
    p["c1"]["bias"] = np.ones_like(p["c1"]["bias"])
    return p


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(config path, JAX task, port task, params), both tasks bound to the
    same params."""
    path = _small_config(tmp_path_factory.mktemp("cfg"))
    jt = JaxPx2PxTask(jax_load_config(path))
    params = _positive_params()
    jt.bind(params)
    port = Px2PxTask(load_config(path), device="cpu").bind(params_from_jax(params))
    return path, jt, port, params


def _dataset(n=16):
    return FakeDataset(image_size=SIZE, length=n, return_coords=True, seed=1)


def _assert_metrics_close(got: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert list(got.columns) == list(ref.columns)
    assert list(got["id"]) == list(ref["id"])
    for c in METRIC_COLUMNS:
        np.testing.assert_allclose(got[c].values, ref[c].values, rtol=0, atol=ATOL,
                                   err_msg=c)
    for c in GROUPS:
        assert list(got[c]) == list(ref[c]), c


# ---------------------------------------------------------------- the copies
@pytest.mark.parametrize("shape,t", [((3, 10, 12), 6), ((10, 12), 5), ((1, 7, 7), 7)])
def test_crop_center_equals_jax(shape, t):
    im = np.arange(np.prod(shape)).reshape(shape)
    np.testing.assert_array_equal(crop_center(im, t), jax_crop(im, t))
    with pytest.raises(AssertionError):
        crop_center(im, 20)


def test_per_sample_metrics_match_jax():
    """Every (B,) vector against the jitted JAX program, rtol 1e-5."""
    rng = np.random.default_rng(0)
    rgb = rng.random((3, 24, 24, 3)).astype(np.float32)
    nir = (0.2 + 0.6 * rng.random((3, 24, 24, 1))).astype(np.float32)
    pred = np.clip(nir + 0.1 * rng.standard_normal(nir.shape), 0, 1).astype(np.float32)
    got = per_sample_metrics(*map(torch.from_numpy, (rgb, nir, pred)))
    ref = jax_psm(*map(jnp.asarray, (rgb, nir, pred)))
    assert sorted(got) == sorted(ref) == sorted(METRIC_COLUMNS)
    for k in ref:
        assert got[k].shape == (3,) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   err_msg=k)


def test_clean_economy_equals_jax():
    df = pd.DataFrame({"ECONOMY": ["1. Developed region: G7", "6. Developing",
                                   None, "nonsense", "3. Emerging region: BRIC"]})
    got, ref = geo_ablation.clean_economy(df), jax_geo.clean_economy(df)
    pd.testing.assert_frame_equal(got, ref)
    assert list(got["economy"])[:2] == ["Developed: G7", "Developing"]


def test_builtin_joins_equal_jax(tmp_path):
    """The ray-casting join (a polygon, a multipolygon with a hole) and the
    Köppen point query through the port's GeoTIFF reader, against JAX's."""
    world = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"SOV_A3": "AAA", "CONTINENT": "Testia",
                                           "ECONOMY": "1. Developed region: G7"},
         "geometry": {"type": "Polygon",
                      "coordinates": [[[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]]]}},
        {"type": "Feature", "properties": {"SOV_A3": "BBB", "CONTINENT": "Testia",
                                           "ECONOMY": "6. Developing region"},
         "geometry": {"type": "MultiPolygon", "coordinates": [
             [[[20, 0], [30, 0], [30, 10], [20, 10], [20, 0]],
              [[24, 4], [26, 4], [26, 6], [24, 6], [24, 4]]],
             [[[40, 40], [42, 40], [42, 42], [40, 42], [40, 40]]]]}}]}
    world_path = str(tmp_path / "world.geojson")
    json.dump(world, open(world_path, "w"))
    kop = np.zeros((1, 50, 50), np.uint8)
    kop[0, :, :25], kop[0, :, 25:] = 3, 7
    kop_path = str(tmp_path / "koppen.tif")
    write_geotiff(kop_path, kop, pixel_scale=(1.0, 1.0), origin=(0.0, 50.0), epsg=4326)
    legend_path = str(tmp_path / "legend.csv")
    pd.DataFrame({"id": [3, 7], "Code": ["Cfb", "Dfc"]}).to_csv(legend_path, index=False)
    df = pd.DataFrame({"x": [5.0, 25.0, 25.0, 41.0, 90.0],
                       "y": [5.0, 5.0, 2.0, 41.0, 0.0], "l1": [0.1] * 5})
    kw = dict(world_path=world_path, koppen_path=kop_path, koppen_legend=legend_path)
    got = geo_ablation.append_info_to_df(df, **kw)
    ref = jax_geo.append_info_to_df(df, **kw)
    pd.testing.assert_frame_equal(got, ref)
    assert list(got["Country"]) == ["AAA", "Unknown", "BBB", "BBB", "Unknown"]
    assert list(got["Koppen_Class"]) == ["C", "D", "D", "D", "U"]
    # no layer: "Unknown" everywhere, as in JAX
    pd.testing.assert_frame_equal(geo_ablation.append_info_to_df(df),
                                  jax_geo.append_info_to_df(df))
    out = results_table.filter_for_countries(df, world_path)
    pd.testing.assert_frame_equal(out, jax_results.filter_for_countries(df, world_path))


@pytest.mark.parametrize("name", ["continents_coarse.geojson", "koppen_coarse.tif",
                                  "koppen_legend.csv"])
def test_shipped_layer_is_the_jax_packages_byte_for_byte(name):
    ours = os.path.join(os.path.dirname(layers.__file__), name)
    theirs = os.path.join(os.path.dirname(jax_layers.__file__), name)
    assert ours != theirs
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_shipped_layers_join_as_jax(monkeypatch):
    """The default layers are the port's own copies and group known places
    as JAX's do; the environment overrides behave alike."""
    assert layers.default_world_path().startswith(os.path.dirname(layers.__file__))
    df = pd.DataFrame({"x": [13.4, -47.9, -98.0, 36.8, 134.0, -150.0],
                       "y": [52.5, -15.8, 39.0, -1.3, -25.0, 0.0], "l1": [0.1] * 6})
    kop, leg = layers.default_koppen_paths()
    got = geo_ablation.clean_economy(geo_ablation.append_info_to_df(
        df, world_path=layers.default_world_path(), koppen_path=kop, koppen_legend=leg))
    jkop, jleg = jax_layers.default_koppen_paths()
    ref = jax_geo.clean_economy(jax_geo.append_info_to_df(
        df, world_path=jax_layers.default_world_path(), koppen_path=jkop,
        koppen_legend=jleg))
    pd.testing.assert_frame_equal(got, ref)
    assert list(got["Continent"])[:3] == ["Europe", "South America", "North America"]
    monkeypatch.setenv("NIRGAN_WORLD_LAYER", "/nonexistent.geojson")
    monkeypatch.setenv("NIRGAN_KOPPEN_LAYER", "/nonexistent.tif")
    monkeypatch.setenv("NIRGAN_KOPPEN_LEGEND", "legend.csv")
    assert layers.default_world_path() is None is jax_layers.default_world_path()
    assert layers.default_koppen_paths() == jax_layers.default_koppen_paths() \
        == (None, "legend.csv")


def test_points_to_geojson_equals_jax(tmp_path):
    df = pd.DataFrame({"id": [0, 1], "x": [1.5, -2.0], "y": [3.0, 4.25],
                       "psnr": np.float32([20.5, 31.0]), "Country": ["AAA", "Unknown"],
                       "ECONOMY": [None, "6. Developing"], "index_right": [0, 1]})
    geo_ablation.points_to_geojson(df, str(tmp_path / "port.geojson"))
    jax_geo.points_to_geojson(df, str(tmp_path / "jax.geojson"))
    assert (tmp_path / "port.geojson").read_text() == (tmp_path / "jax.geojson").read_text()
    back = spiders.read_metric_geojson(str(tmp_path / "port.geojson"))
    assert list(back["x"]) == [1.5, -2.0] and list(back["Country"]) == ["AAA", "Unknown"]


# ------------------------------------------------------------------ the sweep
def test_spider_sweep_matches_jax(pair, tmp_path):
    """The same generator and FakeDataset through both sweeps: the CSV's
    metric columns within the generator bound, the groups equal, the same
    files (example panels at samples 0 and 8)."""
    _, jt, port, _ = pair
    kw = dict(satclip=False, epoch_no=3, batch_size=8, plot_every=8)
    got = spider_validation_callback(port, _dataset(), folder=str(tmp_path / "p"), **kw)
    ref = jax_spider(jt, _dataset(), folder=str(tmp_path / "j"), **kw)
    _assert_metrics_close(got, ref)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p" / "images")) == [
        "example_image_0000_NoSatCLIP.png", "example_image_0008_NoSatCLIP.png"]
    csv = pd.read_csv(tmp_path / "p" / "validation_metrics.csv", index_col=0)
    np.testing.assert_allclose(
        csv[METRIC_COLUMNS].values,
        pd.read_csv(tmp_path / "j" / "validation_metrics.csv", index_col=0)[
            METRIC_COLUMNS].values, rtol=0, atol=ATOL)
    fc = json.load(open(tmp_path / "p" /
                        "validation_metrics_ablation_satclip_False_e3.geojson"))
    assert len(fc["features"]) == 16
    # max_samples stops after the batch that reaches it
    again = spider_validation_callback(port, _dataset(), folder=str(tmp_path / "m"),
                                       max_samples=3, **kw)
    assert list(again["id"]) == list(range(8))


def test_panels_equal_jax_and_draw_without_matplotlib(tmp_path, monkeypatch):
    """``plot_tensors`` is JAX's figure pixel for pixel; without matplotlib
    (an installation without it) it and the radar comparison draw with PIL."""
    rng = np.random.default_rng(1)
    rgb, nir, pred = (rng.random((2, c, 24, 24), np.float32) for c in (3, 1, 1))
    got = np.asarray(logging_helpers.plot_tensors(rgb, nir, pred))
    assert np.array_equal(got, np.asarray(jax_helpers.plot_tensors(rgb, nir, pred)))
    df = pd.DataFrame({"Continent": ["A", "B", "C", "A"], "psnr": [20.0, 25.0, 30.0, 22.0],
                       "ssim": [0.5, 0.6, 0.7, 0.55]})
    mpl = spiders.plot_radar_comparison(df, df, "Continent", folder=str(tmp_path / "mpl"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    img = logging_helpers.plot_tensors(rgb, nir, pred)
    assert img.size == (8 + 3 * 32, 24 + 8 + 2 * 32)
    out = spiders.plot_radar_comparison(df, df.iloc[:2], "Continent",
                                        folder=str(tmp_path / "pil"))
    assert os.path.basename(out) == os.path.basename(mpl)
    from PIL import Image

    assert Image.open(out).size == (1200, 600)


def test_create_val_metrics_from_a_reference_ckpt_and_a_run(pair, tmp_path):
    """A reference ``.ckpt`` written by the JAX package's exporter: the
    port's ``create_val_metrics`` gives the rows of the JAX sweep of those
    params over the config's val split (``create_val_metrics`` of the JAX
    package, less its compile of a train state).  The port's run directory
    (``best.pt`` first), its ``last.pt`` and a reference ``.pt`` give the
    same rows bit for bit; other files and orbax directories raise."""
    path, jt, port, params = pair
    ckpt = export_px2px_checkpoint(params, None, jax_load_config(path),
                                   str(tmp_path / "ref.ckpt"))
    got = results_table.create_val_metrics(path, str(tmp_path / "p"), weights_path=ckpt,
                                           max_samples=8, device="cpu")
    ref = jax_spider(jt, jax_dataset_selector(jax_load_config(path)).val_ds,
                     satclip=False, folder=str(tmp_path / "j"), max_samples=8)
    assert len(got) == 8
    _assert_metrics_close(got, ref)

    run = tmp_path / "run"
    state = port.init_state()
    CheckpointManager(str(run)).save(port, state, {"val/L1": 0.5})
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    torch.save({"state_dict": sd}, str(tmp_path / "ref.pt"))
    for weights in (str(run), str(run / "last.pt"), str(tmp_path / "ref.pt")):
        again = results_table.create_val_metrics(path, str(tmp_path / "r"),
                                                 weights_path=weights, max_samples=8,
                                                 device="cpu")
        pd.testing.assert_frame_equal(again, got)
    torch.save({"weights": torch.zeros(1)}, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="neither"):
        results_table.create_val_metrics(path, str(tmp_path / "r"), device="cpu",
                                         weights_path=str(tmp_path / "bad.pt"))
    os.makedirs(tmp_path / "orbax" / "best")
    with pytest.raises(ValueError, match="orbax"):
        results_table.create_val_metrics(path, str(tmp_path / "r"), device="cpu",
                                         weights_path=str(tmp_path / "orbax"))


def test_run_comparison_and_the_cli(tmp_path, capsys):
    """``--compare`` writes both GeoJSONs and the three radar plots;
    ``--config`` with ``--quant int8`` writes the rows; ``--device cuda``
    without a card raises."""
    plain = _small_config(tmp_path)
    sat = _small_config(tmp_path, "config_px2px_SatCLIP.yaml")
    folder, plots = validate.main(["--compare", sat, plain, "--out", str(tmp_path / "c"),
                                   "--max-samples", "4", "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in plots) == [
        "metrics_radar_satclip_Continent.png", "metrics_radar_satclip_Koppen_Class.png",
        "metrics_radar_satclip_economy.png"]
    assert all(os.path.isfile(p) for p in plots)
    for tag in ("True", "False"):
        fc = json.load(open(os.path.join(
            folder, f"validation_metrics_ablation_satclip_{tag}_e0.geojson")))
        assert len(fc["features"]) == 8  # max_samples rounds up to a batch of 8
    gdf = validate.main(["--config", plain, "--out", str(tmp_path / "q"), "--quant",
                         "int8", "--max-samples", "8", "--device", "cpu"])
    assert len(gdf) == 8 and np.isfinite(gdf[METRIC_COLUMNS].values).all()
    assert "wrote 8 per-sample rows" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate.main(["--config", plain])


# --------------------------------------------------------------- time series
def test_time_series_matches_jax(pair, tmp_path):
    """A dated ``.npz`` stack: with ``model=None`` (``nir * 1.15``) equal to
    JAX's, with the generator within its bound; the timeline image; a
    ``device`` other than the task's raises."""
    _, jt, port, _ = pair
    rng = np.random.default_rng(0)
    for date in ("20230101", "20230315", "20230601"):
        np.savez(tmp_path / f"S2_{date}T101031_tile.npz",
                 image=(rng.random((4, 48, 48)) * 10000).astype(np.uint16))
    np.savez(tmp_path / "S2_SKIP_bad.npz", image=np.zeros((4, 8, 8), np.uint16))
    glob_ = str(tmp_path / "*.npz")
    got = time_series.get_pred_nirs_and_info(model=None, root_dir=glob_, size_input=SIZE)
    ref = jax_ts.get_pred_nirs_and_info(model=None, root_dir=glob_, size_input=SIZE)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3] == ["20230101", "20230315", "20230601"]
    got = time_series.get_pred_nirs_and_info(model=port, root_dir=glob_, size_input=SIZE)
    ref = jax_ts.get_pred_nirs_and_info(model=jt, root_dir=glob_, size_input=SIZE)
    assert got[2].shape == (3, 1, SIZE, SIZE)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=ATOL)
    img = time_series.calculate_and_plot_timeline(model=port, device="cpu",
                                                  root_dir=glob_, size_input=SIZE)
    assert img.size[0] > 100
    with pytest.raises(ValueError, match="runs on cpu"):
        time_series.calculate_and_plot_timeline(model=port, device="cuda",
                                                root_dir=glob_, size_input=SIZE)


def test_plot_clc_panels_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    rgb, nir, pred = (rng.random((c, 16, 16), np.float32) for c in (3, 1, 1))
    mask = rng.integers(0, 5, (16, 16))
    got = plot_clc.plot_rgb_nir_and_mask(rgb, nir, pred, mask, it=1, title="t",
                                         out_dir=str(tmp_path))
    ref = jax_plot_clc.plot_rgb_nir_and_mask(rgb, nir, pred, mask, it=1, title="t")
    assert np.array_equal(np.asarray(got), np.asarray(ref))
    assert (tmp_path / "clc_mask_1.png").is_file()
    assert np.array_equal(np.asarray(plot_clc.plot_rgb_and_mask(rgb, mask)),
                          np.asarray(jax_plot_clc.plot_rgb_and_mask(rgb, mask)))


def _cell(img, i, j, shape, slot):
    """Cell (i, j) of a ``pil_plots.image_grid`` whose slots are ``slot``
    (width, height) and whose cell there is ``shape`` (H, W)."""
    pad, top = 8, 24
    x, y = pad + j * (slot[0] + pad), top + pad + i * (slot[1] + pad)
    return np.asarray(img)[y:y + shape[0], x:x + shape[1]]


def test_figures_equal_jax_and_draw_without_matplotlib(tmp_path, monkeypatch):
    """The trainer's panels (``plot_tensors_hist``, ``plot_index``), the
    serving CLI's example plot, the timeline and the CLC figures: with
    matplotlib JAX's figures pixel for pixel; without it (``matplotlib`` not
    importable) the same images drawn with PIL: each panel's pixels are its
    array through the same colour map (``pil_plots``), the histograms the
    matplotlib route's values."""
    from nirgan_tpu.inference.synthesize import _plot_example as jax_plot_example
    from nirgan_tpu_torch.inference.synthesize import _plot_example
    from nirgan_tpu_torch.utils import pil_plots

    rng = np.random.default_rng(5)
    rgb, nir, pred = (rng.random((2, c, 24, 24), np.float32) for c in (3, 1, 1))
    for name in ("plot_tensors_hist", "plot_index"):
        got = np.asarray(getattr(logging_helpers, name)(rgb, nir, pred))
        assert np.array_equal(got, np.asarray(getattr(jax_helpers, name)(rgb, nir, pred)))
    stack = {"rgbs": rng.random((4, 3, 16, 16)), "nirs": rng.random((4, 1, 16, 16)),
             "preds": rng.random((4, 1, 16, 16))}
    stamps = ["20230101", "20230201", "20230301", "20230401"]
    args = (stack["rgbs"], stack["nirs"], stack["preds"], stamps, 4)
    assert np.array_equal(np.asarray(time_series.plot_timeline(*args)),
                          np.asarray(jax_ts.plot_timeline(*args)))
    batch = {"hr": rng.integers(0, 3000, (1, 3, 32, 32), np.uint16),
             "lr": rng.integers(0, 3000, (1, 3, 8, 8), np.uint16),
             "s2_nir": rng.integers(0, 3000, (1, 1, 32, 32), np.uint16)}
    example = rng.random((1, 1, 32, 32), np.float32)
    _plot_example(batch, example, 0, str(tmp_path / "port"))
    jax_plot_example(batch, example, 0, str(tmp_path / "jax"))
    from PIL import Image

    png = str(tmp_path / "port" / "example_0.png")
    mpl_size = Image.open(png).size
    assert np.array_equal(np.asarray(Image.open(png)),
                          np.asarray(Image.open(str(tmp_path / "jax" / "example_0.png"))))

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not pil_plots.has_matplotlib()
    # plot_tensors_hist: RGB, NIR and prediction through viridis, histograms
    img = logging_helpers.plot_tensors_hist(rgb, nir, pred)
    p_rgb, p_nir, p_pred, n, centers, hists = logging_helpers._hist_panels(rgb, nir, pred)
    slot = (240, 180)  # the chart's least size, larger than the 24^2 images
    for i in range(n):
        assert np.array_equal(_cell(img, i, 1, (24, 24), slot),
                              pil_plots.colormap(p_nir[i, 0], "viridis"))
        assert np.array_equal(_cell(img, i, 2, (24, 24), slot),
                              pil_plots.colormap(p_pred[i, 0], "viridis"))
        bins = np.linspace(0, 1, 101)
        np.testing.assert_array_equal(
            hists[i][0], np.histogram(p_nir[i, 0], bins=bins)[0] / p_nir[i, 0].size)
    # plot_index: the NDVI panels through RdYlGn
    img = logging_helpers.plot_index(rgb, nir, pred)
    rows = logging_helpers._ndvi_panels(rgb, nir, pred)
    for i, (_, actual, predicted) in enumerate(rows):
        assert np.array_equal(_cell(img, i, 1, (24, 24), (24, 24)), pil_plots.colormap(actual))
        assert np.array_equal(_cell(img, i, 2, (24, 24), (24, 24)),
                              pil_plots.colormap(predicted))
    # the CLC figure: viridis on [0, 1] and the class colours
    mask = rng.integers(0, 5, (24, 24))
    img = plot_clc.plot_rgb_nir_and_mask(rgb[0], nir[0], pred[0], mask, it=2,
                                         out_dir=str(tmp_path))
    assert (tmp_path / "clc_mask_2.png").is_file()
    assert np.array_equal(_cell(img, 0, 1, (24, 24), (24, 24)),
                          pil_plots.colormap(nir[0, 0], "viridis", 0, 1))
    classes = _cell(img, 0, 3, (24, 24), (24, 24))
    assert np.array_equal(classes, pil_plots.listed(mask, plot_clc.CLC_COLORS, 0, 4))
    assert {tuple(c) for c in classes.reshape(-1, 3)} <= {
        tuple(int(h[k:k + 2], 16) for k in (1, 3, 5)) for h in plot_clc.CLC_COLORS}
    assert plot_clc.plot_rgb_and_mask(rgb[0], mask, title="t").size[0] > 48
    # the timeline: the chart over the RGB panels
    img = time_series.plot_timeline(*args)
    assert img.size[0] >= 1200 and img.size[1] > 420
    # the serving CLI's example: the four panels
    _plot_example(batch, example, 0, str(tmp_path / "pil"))
    pil = Image.open(str(tmp_path / "pil" / "example_0.png"))
    assert pil.size != mpl_size
    assert np.array_equal(_cell(pil, 0, 2, (32, 32), (32, 32)),
                          pil_plots.colormap(example[0, 0], "gray"))


def test_trainer_logs_its_panels_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the train CLI still logs ``Images/Val NIR`` and,
    with ``log_ndvi`` (on in ``config_px2px.yaml``), ``Images/Val NDVI`` at
    each validation, drawn with PIL: no panel is skipped."""
    from tests.test_torch_train import _tiny_config_file

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = _tiny_config_file(tmp_path)
    run = str(tmp_path / "run")
    cli.main(["--config", cfg, "--device", "cpu", "--logdir", run, "--log-every", "2",
              "--max-steps", "2"])
    images = sorted(os.listdir(os.path.join(run, "images")))
    assert images == ["Images_Val_NDVI_00000002.png", "Images_Val_NIR_00000002.png"]


# ---------------------------------------------------------------- the trainer
def _train(tmp_path, name, **experimentation):
    (tmp_path / name).mkdir()
    cfg = _small_config(tmp_path / name, **experimentation)
    run = str(tmp_path / name / "run")
    cli.main(["--config", cfg, "--device", "cpu", "--max-steps", "4", "--logdir", run])
    return run


def test_trainer_save_val_df_writes_each_epoch_and_leaves_training_unchanged(tmp_path):
    """Two epochs of 2 steps: the sweep writes the epoch-1 and epoch-2
    GeoJSONs and the CSV into the logdir, and the final weights and
    optimizer states are bit for bit those of the run without it."""
    with_sweep = _train(tmp_path, "on", save_val_df=True)
    without = _train(tmp_path, "off")
    for epoch in (1, 2):
        fc = json.load(open(os.path.join(
            with_sweep, f"validation_metrics_ablation_satclip_False_e{epoch}.geojson")))
        assert len(fc["features"]) == 8
    assert os.path.isfile(os.path.join(with_sweep, "validation_metrics.csv"))
    assert not any(f.endswith(".geojson") for f in os.listdir(without))
    a, b = (torch.load(os.path.join(r, "last.pt"), weights_only=True)
            for r in (with_sweep, without))
    assert a["step"] == b["step"] == 4
    for net in ("G", "D"):
        assert list(a[net]) == list(b[net])
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net]), net
    for opt in ("opt_g", "opt_d"):
        sa, sb = a[opt]["state"], b[opt]["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]), opt


def test_trainer_sweep_rebuilds_the_int8_pack(tmp_path):
    """With ``serving_quant: int8`` each epoch's sweep calibrates a pack of
    the weights it serves: two sweeps, two packs, and they differ."""
    packs = []
    real = Px2PxTask.build_trunk_q

    def spy(self, *args, **kw):
        packs.append(real(self, *args, **kw))
        return packs[-1]

    cfg = yaml.safe_load(open(_small_config(tmp_path, save_val_df=True)))
    cfg["tpu"]["serving_quant"] = "int8"
    path = tmp_path / "int8.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with mock.patch.object(Px2PxTask, "build_trunk_q", spy):
        cli.main(["--config", str(path), "--device", "cpu", "--max-steps", "4",
                  "--logdir", str(tmp_path / "run")])
    assert len(packs) == 2
    assert not torch.equal(packs[0]["w1"][0], packs[1]["w1"][0])
    for epoch in (1, 2):
        assert (tmp_path / "run" /
                f"validation_metrics_ablation_satclip_False_e{epoch}.geojson").is_file()
