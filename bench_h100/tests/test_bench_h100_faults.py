"""A whole run of each cell at a tiny size on the CPU, the harness's look
for a card skipped: correct as the program stands, and not correct with
the timed path broken underneath it."""

from __future__ import annotations

import time

import pytest
from conftest import tiny_cell

from bench_h100 import controls, core

CELLS = [w["name"] for w in core.load_benchmark()["workloads"]]
SERVING = [c for c in CELLS if core.load_cell(core.load_benchmark(), c).driver == "serve"]


def _run(name: str, seed: int = 2**31 + 5) -> core.Run:
    cell = tiny_cell(name)
    return core.driver(cell.driver).run(cell, seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    run = _run(name)
    assert run.correct, run.checks
    assert run.work > 0 and run.end_to_end["setup_s"] > 0


def _faults(kind: str) -> list:
    return sorted(k for k, v in controls.FAULTS.items() if v[0] == kind)


@pytest.mark.parametrize("fault", _faults("train"))
def test_train_step_fault(fault):
    """A step that leaves the state unchanged, one that leaves half of the
    batch out, and ones that leave one leaf unmoved."""
    with controls.planted(fault):
        run = _run("train512_b16")
    assert not run.correct, run.checks


@pytest.mark.parametrize("fault", _faults("scene"))
def test_scene_fault(fault):
    """The tower's embeddings zeroed, longitude and latitude swapped, the
    inject left out: the whole scene cannot see them, the taps do."""
    with controls.planted(fault):
        run = _run("scene10980_inject_b32")
    assert not run.correct, run.checks


@pytest.mark.parametrize("name", SERVING)
def test_answer_altered_where_it_is_produced(monkeypatch, name):
    from nirgan_tpu_torch.inference import synthesize

    serve_batch = synthesize.serve_batch

    def swapped(*args, **kwargs):
        return serve_batch(*args, **kwargs).roll(1, dims=0)

    monkeypatch.setattr(synthesize, "serve_batch", swapped)
    run = _run(name)
    assert not run.correct, run.checks


def test_scene_altered_where_it_is_produced(monkeypatch):
    from nirgan_tpu_torch.inference import scene

    blend_scene = scene.blend_scene

    def flipped(*args, **kwargs):
        nir, offset = blend_scene(*args, **kwargs)
        return nir.flip(-1), offset

    monkeypatch.setattr(scene, "blend_scene", flipped)
    run = _run("scene10980_inject_b32")
    assert not run.correct, run.checks
