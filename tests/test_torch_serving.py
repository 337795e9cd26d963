"""The port's serving path against the JAX package's, on the CPU: the task's
``predict_step``, the bulk ``synthesize_dataset``, the CLI end to end, and
the port's freedom from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from nirgan_tpu.config import load_config
from nirgan_tpu.inference import synthesize_dataset as jax_synthesize_dataset
from nirgan_tpu.tasks import Px2PxTask as JaxPx2PxTask
from nirgan_tpu_torch import create_synthetic_dataset as cli
from nirgan_tpu_torch.inference import synthesize_dataset
from nirgan_tpu_torch.tasks import Px2PxTask
from nirgan_tpu_torch.weights import params_from_jax
from tests.conftest import REPO_ROOT
from tests.test_inference import _TinySRDataset


def _tiny_config():
    cfg = load_config("configs/config_px2px.yaml")
    cfg.base_configs.ngf = 8
    cfg.base_configs.ndf = 8
    cfg.Data.padding_amount = 2
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.shape_buckets = [64]
    return cfg


@pytest.fixture(scope="module")
def tasks():
    """The JAX task with seeded params and the port's task bound to the
    same weights."""
    cfg = _tiny_config()
    jax_task = JaxPx2PxTask(cfg)
    state = jax_task.init_state(seed=0, image_size=64)
    jax_task.bind(state)
    port = Px2PxTask(cfg, device="cpu")
    port.bind(params_from_jax(jax.device_get(state.params_g)))
    return jax_task, port


def test_predict_step_matches_jax(tasks):
    """Odd 50x60 tiles go through the reflect pad to bucket 64, which
    changes the IN statistics, so both stacks must pad alike; f32, the
    generator bound atol 2e-5."""
    jax_task, port = tasks
    rgb = np.random.default_rng(3).random((2, 3, 50, 60), dtype=np.float32)
    ref = jax_task.predict_step(rgb)
    got = port.predict_step(rgb)
    assert got.shape == (2, 1, 50, 60) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_bucket_for_matches_jax(tasks):
    jax_task, port = tasks
    for h, w in ((50, 60), (64, 64), (65, 10), (200, 129)):
        assert port.bucket_for(h, w) == jax_task.bucket_for(h, w)


def test_dn_to_reflectance_is_true_division(tasks):
    _, port = tasks
    dn = np.array([[0, 1, 3, 7777, 9999, 65535]], np.uint16)
    got = port._dn_to_reflectance(torch.from_numpy(dn), torch.float32).numpy()
    np.testing.assert_array_equal(got, dn.astype(np.float32) / np.float32(10000.0))


def _read_tiles(path):
    return {f: np.load(os.path.join(path, f))["nir"] for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("match", [False, True], ids=["plain", "hist_match"])
def test_synthesize_dataset_matches_jax(tasks, tmp_path, match):
    """Same tiles through both pipelines (5 items, batch 2: a ragged tail).
    Without matching: fp16 outputs within atol 1e-3.  With matching, the
    outputs are values of the S2 reference distribution; generator outputs
    that differ in the last f32 bits may swap the ranks of near-tied pixels,
    which swaps their values, so: 99% of pixels within 1e-3 and all within
    the reference's range."""
    jax_task, port = tasks
    ds = _TinySRDataset()
    n_ref = jax_synthesize_dataset(jax_task, ds, str(tmp_path / "jax"),
                                   batch_size=2, match_histograms=match)
    n = synthesize_dataset(port, ds, str(tmp_path / "port"), batch_size=2,
                           match_histograms=match, plot_dir=str(tmp_path / "plots"),
                           plot_every=2)
    assert n == n_ref == 5
    assert (tmp_path / "plots" / "example_2.png").exists()
    ref, got = _read_tiles(tmp_path / "jax"), _read_tiles(tmp_path / "port")
    assert list(got) == list(ref)
    for name in ref:
        g, r = got[name].astype(np.float32), ref[name].astype(np.float32)
        assert got[name].dtype == np.float16 and got[name].shape == (1, 64, 64)
        if not match:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)
        else:
            assert np.mean(np.abs(g - r) <= 1e-3) >= 0.99
            assert g.min() >= r.min() - 1e-3 and g.max() <= r.max() + 1e-3


def _write_npz_dataset(root, n=3, hr=64, lr=16):
    rng = np.random.default_rng(0)
    for sub in ("HR", "LR"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        np.savez(os.path.join(root, "HR", f"t{i}.npz"),
                 img=rng.integers(0, 3000, (3, hr, hr), dtype=np.uint16))
        np.savez(os.path.join(root, "LR", f"t{i}.npz"),
                 img=rng.integers(0, 3000, (4, lr, lr), dtype=np.uint16))


def test_cli_end_to_end_on_cpu(tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_config().to_dict()))
    data, out = tmp_path / "data", tmp_path / "out"
    _write_npz_dataset(str(data))
    n = cli.main(["--config", str(cfg_path), "--data", str(data), "--out", str(out),
                  "--ckpt", str(tmp_path / "missing.ckpt"), "--batch-size", "2",
                  "--device", "cpu"])
    assert n == 3
    tiles = _read_tiles(out)
    assert sorted(tiles) == ["t0.npz", "t1.npz", "t2.npz"]
    for t in tiles.values():
        assert t.dtype == np.float16 and t.shape == (1, 64, 64)
        assert np.isfinite(t).all()


@pytest.mark.parametrize("argv,message", [
    (["--mesh"], "--mesh"),
    (["--quant", "int8"], "--quant"),
])
def test_cli_rejects_unported_options(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    assert message in capsys.readouterr().err


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--device", "cuda", "--data", str(tmp_path)])


_NO_JAX = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'flax', 'optax', 'orbax')))\n"
    "assert not bad, bad\n"
    "used = sorted(m for m in sys.modules if m.split('.')[0] == 'nirgan_tpu')\n"
    "assert not used, used\n")


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the port, then a serving run and a train
    run through the CLIs on the plain and on the SatCLIP inject route,
    leaves jax and every module of the JAX package out of sys.modules (a
    subprocess: this test process has jax loaded by conftest)."""
    from tests.test_torch_satclip import _small_satclip_file
    from tests.test_torch_train import _tiny_config_file

    satclip_cfg = _small_satclip_file(tmp_path)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_config().to_dict()))
    data = tmp_path / "data"
    _write_npz_dataset(str(data))
    code = (
        "import importlib, pkgutil, sys\n"
        "import nirgan_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 30, names\n"
        + _NO_JAX +
        "from nirgan_tpu_torch import create_synthetic_dataset as serve\n"
        f"n = serve.main(['--config', {str(cfg_path)!r}, '--data', {str(data)!r},\n"
        f"                '--out', {str(tmp_path / 'out')!r}, '--ckpt', 'none.ckpt',\n"
        "                '--batch-size', '2', '--device', 'cpu'])\n"
        "assert n == 3, n\n"
        "from nirgan_tpu_torch.train import cli\n"
        f"cli.main(['--config', {_tiny_config_file(tmp_path)!r}, '--device', 'cpu',\n"
        f"          '--max-steps', '2', '--logdir', {str(tmp_path / 'run')!r}])\n"
        f"n = serve.main(['--config', {satclip_cfg!r}, '--data', {str(data)!r},\n"
        f"                '--out', {str(tmp_path / 'out_sat')!r}, '--ckpt', 'none.ckpt',\n"
        "                '--batch-size', '2', '--device', 'cpu'])\n"
        "assert n == 3, n\n"
        f"cli.main(['--config', {satclip_cfg!r}, '--device', 'cpu',\n"
        f"          '--max-steps', '2', '--logdir', {str(tmp_path / 'run_sat')!r}])\n"
        + _NO_JAX +
        "print('clean', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("clean")


def _port_sources():
    import glob

    files = glob.glob(os.path.join(REPO_ROOT, "nirgan_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO_ROOT, "chip_smoke.py")]


def test_port_sources_name_no_jax_import():
    """No source file of the port, nor ``chip_smoke.py``, has an import
    statement of jax or of the JAX package, at any indentation."""
    import re

    pattern = re.compile(r"^\s*(import\s+(nirgan_tpu|jax)(\.|\s|,|$)"
                         r"|from\s+(nirgan_tpu|jax)(\.\S*)?\s+import\b)")
    files = _port_sources()
    assert len(files) > 40, files
    hits = [f"{os.path.relpath(f, REPO_ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1)
            if pattern.match(line)]
    assert not hits, hits
