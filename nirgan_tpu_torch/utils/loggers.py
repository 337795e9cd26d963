"""Experiment logging: the port's own copy of ``ExperimentLogger`` from
``nirgan_tpu/utils/loggers.py`` with its JSONL backend.

Keeps the reference's metric-name schema (``train/L1``, ``val/PSNR``,
``model_loss/...``, ``indices_loss/...``, SURVEY.md §5.5) so existing
dashboards and compare scripts carry over: one line per log call, ``step``,
``time`` and the metrics as floats.  The TensorBoard and Weights & Biases
backends of the JAX package stay out: ``torch.utils.tensorboard`` loads
TensorFlow where that is installed, and the port needs no network.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["ExperimentLogger"]


class ExperimentLogger:
    def __init__(self, logdir: str, enabled: bool = True):
        """``enabled=False`` turns every log call into a no-op."""
        self.logdir = logdir
        self.enabled = enabled
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a", buffering=1)

    # ------------------------------------------------------------- scalars
    def log_metrics(self, metrics: dict, step: int):
        if not self.enabled:
            return
        clean = {k: float(np.asarray(v)) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(),
                                      **clean}) + "\n")

    # -------------------------------------------------------------- images
    def log_image(self, tag: str, pil_image, step: int):
        if not self.enabled:
            return
        path_dir = os.path.join(self.logdir, "images")
        os.makedirs(path_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(" ", "_")
        pil_image.save(os.path.join(path_dir, f"{safe}_{step:08d}.png"))

    def close(self):
        if self.enabled:
            self._jsonl.close()
