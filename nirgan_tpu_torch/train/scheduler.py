"""ReduceLROnPlateau with torch-default semantics: the port's own copy of
``nirgan_tpu/train/scheduler.py``, with the same ``state_dict`` so a run
resumed across the two packages reads the same ``sched_state_*.json``.

The reference wires only ``patience`` through to torch's scheduler and
(quirk, preserved deliberately) leaves ``factor`` at the torch default 0.1
even though the configs carry ``Schedulers.factor_*`` (SURVEY.md §5.6;
``model/pix2pix.py:488-489``).  ``Trainer`` reproduces exactly that wiring.

This is host-side state: it rewrites the live ``lr_g``/``lr_d`` scalars in
the TrainState between steps, so no recompilation ever happens.
"""

from __future__ import annotations

__all__ = ["ReduceLROnPlateau"]


class ReduceLROnPlateau:
    def __init__(self, mode: str = "min", factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            bar = (self.best * (1.0 - self.threshold)
                   if self.threshold_mode == "rel" else self.best - self.threshold)
            return current < bar
        bar = (self.best * (1.0 + self.threshold)
               if self.threshold_mode == "rel" else self.best + self.threshold)
        return current > bar

    def step(self, metric: float, lr: float) -> float:
        """Record an epoch metric; return the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
            return max(lr * self.factor, self.min_lr)
        return lr
