"""Checkpoints, counterpart of ``nirgan_tpu/train/checkpoint.py``.

The reference's mechanisms (PL ``ModelCheckpoint(monitor='val/L1',
mode='min', save_last=True, save_top_k=1)``, ``train.py:99-103``): ``last``
after every validation and ``best`` on an improvement of the monitored
metric, each one ``torch.save`` file of {step, G, D, both optimizer states,
lr_g, lr_d, the dropout generator's state} written under a private name and
renamed, so a crash never leaves half a checkpoint.  The state_dicts carry
the batch norms' running statistics; a task without a discriminator (the
baselines) saves no D.  ``merge_state_dict`` is the strict=False warm
start of ``merge_params``; ``run_checkpoint`` finds the file of a run
directory, ``best`` first.  The JAX package's orbax directories are not read.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import torch

__all__ = ["CheckpointManager", "merge_state_dict", "run_checkpoint"]


def merge_state_dict(module: torch.nn.Module,
                     loaded: Mapping[str, torch.Tensor]) -> None:
    """strict=False semantics: copy every tensor of ``loaded`` whose name
    and shape match into ``module``; ignore the rest."""
    own = module.state_dict()
    keep = {k: v for k, v in loaded.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    module.load_state_dict(keep, strict=False)


def _load_in_saved_dtype(module: torch.nn.Module,
                         saved: Mapping[str, torch.Tensor]) -> None:
    """``module.load_state_dict(saved, strict=True)`` with each parameter
    first given its saved dtype: a run made with ``tpu.param_dtype`` bf16
    or f16 builds its networks in that dtype, and the JAX step's first
    update turns them f32, which the checkpoint holds; a plain copy would
    round them back.  Each parameter keeps its object, so the optimizer's
    references stay valid."""
    with torch.no_grad():
        for k, p in module.named_parameters():
            if k in saved and saved[k].dtype != p.dtype:
                p.data = torch.empty_like(p, dtype=saved[k].dtype)
    module.load_state_dict(saved, strict=True)


def run_checkpoint(path: str) -> str:
    """A checkpoint file of the trainer: ``path`` itself if it is a file,
    else the ``best.pt`` (or, without one, the ``last.pt``) of the run
    directory ``path``.  The JAX package's orbax directories (``best/``,
    ``last/``) need jax and raise with the reason."""
    if os.path.isfile(path):
        return path
    p = path.rstrip("/")
    for which in ("best", "last"):
        if CheckpointManager.exists(p, which):
            return os.path.join(p, f"{which}.pt")
    if os.path.basename(p) in ("best", "last") or any(
            os.path.isdir(os.path.join(p, w)) for w in ("best", "last")):
        raise ValueError(f"{path}: an orbax checkpoint directory needs the JAX "
                         "package; pass a run directory of the port's trainer "
                         "(best.pt / last.pt) or one of those files")
    raise FileNotFoundError(f"{path}: no best.pt or last.pt there")


class CheckpointManager:
    """best/last checkpointing of a task's networks and a ``TrainState``;
    ``best`` is the lowest value of the monitored metric."""

    def __init__(self, directory: str, monitor: str = "val/L1"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.best_metric: Optional[float] = None
        self._meta_path = os.path.join(self.directory, "ckpt_meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best_metric = json.load(f).get("best_metric")

    @staticmethod
    def exists(directory: str, which: str = "last") -> bool:
        return os.path.isfile(os.path.join(directory, f"{which}.pt"))

    def path(self, which: str) -> str:
        return os.path.join(self.directory, f"{which}.pt")

    def has(self, which: str = "last") -> bool:
        return self.exists(self.directory, which)

    def _write(self, which: str, blob: dict) -> None:
        tmp = self.path(which) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self.path(which))

    def save(self, task, state, metrics: Mapping) -> bool:
        """Save ``last``, and ``best`` on an improvement of the monitored
        metric.  Returns True if this was a new best."""
        blob = {"step": int(state.step), "G": task.netG.state_dict(),
                "opt_g": state.opt_g.state_dict(),
                "lr_g": state.lr_g, "lr_d": state.lr_d}
        if getattr(task, "netD", None) is not None:
            blob["D"] = task.netD.state_dict()
        if state.opt_d is not None:
            blob["opt_d"] = state.opt_d.state_dict()
        if state.rng is not None:
            blob["rng"] = state.rng.get_state()
        value = metrics.get(self.monitor)
        improved = False
        if value is not None:
            value = float(value)
            if self.best_metric is None or value < self.best_metric:
                self.best_metric = value
                self._write("best", blob)
                improved = True
        self._write("last", blob)
        with open(self._meta_path, "w") as f:
            json.dump({"best_metric": self.best_metric, "step": int(state.step)},
                      f)
        return improved

    def restore(self, task, state, which: str = "last"):
        """Full resume into ``task``'s networks and ``state``'s optimizers;
        returns ``state`` with its step and learning rates restored, or
        None if there is no such checkpoint."""
        if not self.has(which):
            return None
        blob = torch.load(self.path(which), map_location=task.device,
                          weights_only=True)
        _load_in_saved_dtype(task.netG, blob["G"])
        state.opt_g.load_state_dict(blob["opt_g"])
        if "D" in blob:
            _load_in_saved_dtype(task.netD, blob["D"])
            state.opt_d.load_state_dict(blob["opt_d"])
        if "rng" in blob and state.rng is not None:
            state.rng.set_state(blob["rng"].cpu())
        state.step = int(blob["step"])
        state.set_lr(blob["lr_g"], blob["lr_d"])
        return state
