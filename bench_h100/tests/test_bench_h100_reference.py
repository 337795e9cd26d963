"""The plain reference against the program's plain route (the CPU's),
float32 at a tiny size, and the control (float8 operands) against the
cells' limits at that size."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from bench_h100 import controls, core
from bench_h100.drivers import program_config, seeded_weights
from bench_h100.reference import pix2pix
from bench_h100.reference import serve as ref_serve

CPU = torch.device("cpu")
CELLS = [w["name"] for w in core.load_benchmark()["workloads"]]


def test_generator_matches_the_program():
    from nirgan_tpu_torch.tasks.px2px import Px2PxTask

    cell = tiny_cell("train512_b16")
    task = Px2PxTask(program_config(cell), device="cpu", seed=3)
    wg, _ = seeded_weights(cell, 3, CPU)
    task.bind(wg)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = task.g_apply(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        want = pix2pix.g_apply(wg, x, cell.config)
    assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_train_step_matches_the_program(seed):
    got = controls.program(tiny_cell("train512_b16"), seed, CPU, 0)
    assert max(got.values()) < 1e-4, got


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_serving_matches_the_program(seed):
    got = controls.program(tiny_cell("serve512_bf16_b32"), seed, CPU, 4)
    assert got["rel_rmse"] < 2e-2, got


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_scene_matches_the_program(seed):
    got = controls.program(tiny_cell("scene10980_inject_b32"), seed, CPU, 1)
    assert max(got.values()) < 1e-4, got


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_int8_serving_near_the_program(seed):
    """The program rounds each int8 conv's accumulator to bf16 before its
    norm (and folds the scales in float32): a few % from the exact integer
    reference at this size, an int4 trunk is tens of %."""
    cell = tiny_cell("serve512_int8_b32")
    got = controls.program(cell, seed, CPU, 4)
    assert got["rel_rmse"] < cell.limits["rel_rmse"], got


def test_satclip_tower_matches_the_program():
    from nirgan_tpu_torch.models.satclip.location_encoder import LocationEncoder

    from bench_h100.reference import satclip

    ll = np.array([[9.1, 45.5], [-70.3, -33.1], [179.0, 89.0], [0.0, 0.0]])
    w = satclip.siren_weights(5, CPU)
    got = LocationEncoder(w, legendre_polys=10)(torch.from_numpy(ll)).numpy()
    assert np.abs(got - satclip.embed(w, ll)).max() < 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = tiny_cell(name)
    for seed in (1, 2, 3):
        got = controls.control(cell, seed, CPU)
        assert any(got[k] > lim for k, lim in cell.limits.items()), (seed, got)


def test_histogram_match_is_skimage():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, (16, 16)).astype(np.float64)
    tmpl = rng.normal(size=(8, 8))
    out = ref_serve.match_histogram(src, tmpl)
    # ties share one value, the order of the source is kept, the range is
    # the template's
    assert len(np.unique(out)) == len(np.unique(src))
    assert np.all(np.diff(out.ravel()[np.argsort(src.ravel(), kind="stable")]) >= 0)
    assert out.max() <= tmpl.max() and out.min() >= tmpl.min()
