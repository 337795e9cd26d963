"""The harness: finds a cell's files by name, runs its driver, reads the
per-layer metrics, checks the process for JAX and prints the result line.

A driver (``drivers/<name>.py``) has one function, ``run(cell, seed,
seconds, trace, device, t_start) -> Run``: it builds the program, warms up
the cell's own shapes, measures for ``seconds``, reads the peak memory,
frees the program and has the plain reference judge what the timed path
produced.  Everything here that is not a driver works on the CPU too, so
the tests run a whole cell at a tiny size without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import yaml

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache a run writes, at a fixed path inside the checkout
CACHE_DIR = ROOT / ".bench_h100_cache"
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nirgan_tpu")


class BenchError(RuntimeError):
    """A cell, configuration or file that the benchmark cannot run."""


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files:
    ``config`` the parsed YAML of ``configs/<config>.yaml``, ``traffic``
    the parameters of ``traffic/<traffic>.json``, ``settings`` those of
    ``workloads/<name>.json`` (the driver, the batch, the limits)."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    settings: dict

    @property
    def driver(self) -> str:
        return self.settings["driver"]

    @property
    def limits(self) -> dict:
        return self.settings["limits"]


@dataclass
class Run:
    """What a driver measured and what the reference found."""

    end_to_end: dict  # end-to-end metric -> value, setup_s included
    window_s: float  # the measured window's wall time
    units: int  # steps or batches in the window
    work: int  # images or tiles completed in the window
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    spans: dict = field(default_factory=dict)  # span -> [seconds, count]
    trace: Optional[object] = None  # trace.DeviceTrace of the traced window
    shapes: dict = field(default_factory=dict)  # what the FLOP counts need
    marks: list = field(default_factory=list)  # (set-up stage, seconds since start)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            v == v and v <= limit for v, limit in self.checks.values())


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _data(kind: str, name: str, suffix: str = ".json") -> dict:
    path = HERE / kind / f"{name}{suffix}"
    if not path.exists():
        raise BenchError(f"no {kind} file {path.relative_to(ROOT)}")
    text = path.read_text()
    return yaml.safe_load(text) if suffix == ".yaml" else json.loads(text)


def load_cell(bench: dict, name: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json")
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], traffic_name=entry["traffic"],
                config=_data("configs", entry["config"], ".yaml"),
                traffic=_data("traffic", entry["traffic"]),
                settings=_data("workloads", name))


def forbidden_modules(names=None) -> list:
    """The modules in ``names`` (default ``sys.modules``) whose top-level
    name, the part before the first dot taken whole, is one of
    ``FORBIDDEN``: ``nirgan_tpu.x`` is, ``nirgan_tpu_torch.x`` is not."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def reader(metric: str) -> Callable:
    """``read(run, cell)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"no reader {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"bench_h100.drivers.{name}")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell."""
    return cell in metric.get("workloads", [cell])


def result_line(bench: dict, cell: Cell, run: Run, trace: bool,
                device: dict) -> dict:
    e2e = [m for m in bench["end_to_end"] if reports(m, cell.name)]
    metrics = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": float(run.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not reports(m, cell.name):
                continue
            value = reader(m["name"])(run, cell)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in run.checks.items()}
    return line


def set_cache_dirs() -> None:
    """Every compiler cache a library of the run could write goes under
    ``CACHE_DIR``, at fixed paths (the program's own kernels build into
    ``nirgan_tpu_torch/_build``, inside the checkout too)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)


def main(args, t_start: float) -> int:
    set_cache_dirs()
    try:
        bench = load_benchmark()
        cell = load_cell(bench, args.workload)
    except BenchError as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_h100: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}: no result", file=sys.stderr)
        return 2
    run = driver(cell.driver).run(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print("bench_h100: the process holds JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = result_line(bench, cell, run, bool(args.trace), device)
    print("set-up: " + ", ".join(f"{k} {t:.2f} s" for k, t in run.marks), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
