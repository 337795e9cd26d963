"""Serving: the bulk synthesis (``synthesize``), whole scenes (``scene``),
histogram matching and the exported serving program (``export``).  The
names below are imported on first use, so loading an exported program
(``nirgan_tpu_torch.inference.export``) brings in ``nirgan_tpu_torch.ops``
and nothing else of the package."""

import importlib

_WHERE = {
    "export_generator": "export", "load_exported": "export", "run_exported": "export",
    "histogram_match": "histogram",
    "synthesize_scene": "scene",
    "serve_batch": "synthesize", "synthesize_dataset": "synthesize",
}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
