"""The benchmark's own tests: ``python -m pytest bench_h100/tests -q`` from
the repository root.  Tests marked ``card`` need an NVIDIA card and skip
without one; the rest run a whole cell on the CPU at a tiny size."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import core  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures nothing on a CPU")


def tiny_cell(name: str) -> core.Cell:
    """``name``'s cell at a size a CPU test holds: ngf and ndf 8, six
    blocks (nine on the inject route), float32, 32^2 tiles at batch 4 (an 80^2 scene in them); its
    limits as committed."""
    cell = core.load_cell(core.load_benchmark(), name)
    c = copy.deepcopy(cell.config)
    # the inject generator is built for nine blocks only
    blocks = 9 if c.get("satclip", {}).get("use_satclip") else 6
    c["base_configs"].update(ngf=8, ndf=8, netG=f"resnet_{blocks}blocks")
    c["tpu"].update(compute_dtype="float32", shape_buckets=[32])
    c["Data"].update(num_workers=2, train_batch_size=4)
    traffic = dict(cell.traffic, tile=32, lr_tile=8, distinct=16, length=100000, side=80)
    settings = dict(cell.settings, batch=4, warmup_steps=4, trace_steps=3,
                    trace_batches=3, sample=4, num_workers=2, reference_chunk=2,
                    tile=32, overlap=4, trace_scenes=1)
    return core.Cell(cell.name, 1, cell.config_name, cell.traffic_name, c, traffic,
                     settings)
