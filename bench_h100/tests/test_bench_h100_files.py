"""``BENCHMARK.json`` and the files it names: every cell's configuration,
traffic and settings, every per-layer reader, and the contract's limits on
names, units, bounds and lengths."""

from __future__ import annotations

import json
import re

import pytest
import yaml

from bench_h100 import core

BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = core.load_cell(BENCH, cell)
    assert c.driver in ("train", "serve", "scene")
    assert (core.HERE / "drivers" / f"{c.driver}.py").exists()
    assert c.chips in (1, 4)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    for c in BENCH["configs"]:
        assert c["file"] == f"bench_h100/configs/{c['name']}.yaml"
        data = yaml.safe_load((core.ROOT / c["file"]).read_text())
        assert data["benchmark"]["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        assert sum(core.reports(m, cell) for m in e2e.values()) >= 2


def test_per_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        core.reader(m["name"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert core.reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_paths_hold_names():
    for path in core.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.suffix == ".pyc":
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
