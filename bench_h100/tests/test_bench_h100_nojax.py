"""The check that no run holds JAX or the JAX package, by whole top-level
module names, and that the benchmark's sources import neither."""

from __future__ import annotations

import ast

from bench_h100 import core


def test_top_level_names_compared_whole():
    assert core.forbidden_modules(["nirgan_tpu_torch", "nirgan_tpu_torch.ops.conv",
                                   "torch", "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["nirgan_tpu.x", "nirgan_tpu", "jax", "jax.numpy",
                                   "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "nirgan_tpu",
        "nirgan_tpu.x"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax():
    for path in core.HERE.rglob("*.py"):
        assert core.forbidden_modules(list(_imports(path))) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in (core.HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "nirgan_tpu_torch", (path, name)
