"""The command: no card, or no program beside the benchmark, fails with no
result rather than falling back to the CPU; and, on a card, a cell's
control against its limits at the cell's own size."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_h100 import controls, core


def _cli(cwd, workload="train512_b16"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "bench_h100", "--workload", workload, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc) -> None:
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    proc = _cli(core.ROOT)
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_unknown_cell_no_result():
    _no_result(_cli(core.ROOT, "no_such_cell"))


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_cli(tmp_path))


@pytest.mark.card
@pytest.mark.parametrize("name", ["train512_b16", "serve512_bf16_b32"])
def test_control_on_the_card(card, name):
    import torch

    cell = core.load_cell(core.load_benchmark(), name)
    got = controls.control(cell, 7, torch.device("cuda"))
    assert any(v > cell.limits[k] for k, v in got.items()), got
