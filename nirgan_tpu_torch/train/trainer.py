"""The training loop on one device, counterpart of ``Trainer.fit`` and
``_run_validation`` in ``nirgan_tpu/train/trainer.py`` (the reference's PL
``Trainer`` and callback stack, ``train.py:84-136``).

  * epoch loop with a step cap (``max_steps``); validation every epoch, or
    every ``val_check_interval`` steps, over at most ``limit_val_batches``
  * ``last`` and ``best`` checkpoints on the monitored metric
    (``train/checkpoint.py``), resume from a run dir, weights-only warm
    start from a reference ``.ckpt``
  * two ``ReduceLROnPlateau`` (``train/scheduler.py``), with the factor
    left at 0.1 as the reference's quirk, and their counters in
    ``sched_state_{last,best}.json``, the JAX package's format
  * the finite-loss guard, ``perf/images_per_sec`` and ``perf/step_ms``
  * for the first ``Logging.num_val_images`` validation batches: the image
    panels (``utils/logging_helpers.py``; NDVI with ``Logging.log_ndvi``),
    the six ``val_stats/*`` with ``Logging.log_input_stats``, and with
    ``lambda_rs_losses`` > 0 the six ``indices_loss/*`` errors
  * the train batches fed through ``DeviceFeed`` (``data/pipeline.py``),
    ``tpu.prefetch_depth`` batches ahead on a producer thread (0: the next
    batch prepared in line)
  * ``NIRGAN_PROFILE_DIR``: a ``torch.profiler`` trace of steps 10-20
    written there
  * a SIGTERM checkpoints ``last`` at the next step boundary and returns
  * JSONL logging (``utils/loggers.py``); the JAX package's TensorBoard
    and Weights & Biases backends are not ported
  * ``custom_configs.experimentation.save_val_df``: from epoch 1 on, after
    the checkpoints, the geographic sweep over the whole validation set
    (``validation/spider.py``) writes ``validation_metrics.csv`` and
    ``validation_metrics_ablation_satclip_{satclip}_e{epoch}.geojson`` into
    the logdir.  It serves through ``predict_step`` (eval mode, no
    gradient, no running statistic or dropout draw; an int8 pack of older
    weights is rebuilt, ``Px2PxTask.trunk_q_for``), so training goes on bit
    for bit as without it; a failing sweep is printed and never stops
    training, as in the reference

The task is a ``Px2PxTask`` or a ``BaselineTask``: the loop assumes no
discriminator (the baselines have none; their state has no ``opt_d``).
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import time
import traceback
from typing import Optional

import numpy as np
import torch

from nirgan_tpu_torch.config import save_config, tpu_section
from nirgan_tpu_torch.data.pipeline import DeviceFeed
from nirgan_tpu_torch.train.checkpoint import CheckpointManager, merge_state_dict
from nirgan_tpu_torch.train.scheduler import ReduceLROnPlateau
from nirgan_tpu_torch.utils.loggers import ExperimentLogger
from nirgan_tpu_torch.utils.logging_helpers import plot_index, plot_tensors_hist

__all__ = ["Trainer"]


def _pull(metrics: dict) -> dict:
    """0-d device tensors -> floats, in one copy to the host."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, vals)}


class Trainer:
    def __init__(self, task, datamodule, config, logdir: Optional[str] = None,
                 max_steps: Optional[int] = None,
                 limit_val_batches: Optional[int] = None, log_every: int = 10,
                 seed: Optional[int] = None,
                 val_check_interval: Optional[int] = None):
        """``max_steps``, ``limit_val_batches`` and ``val_check_interval``
        override the config's ``Training`` values where given.  ``seed``
        draws the networks' initial weights anew
        (``Px2PxTask.init_state``), as the JAX trainer's seed makes its
        params; None keeps the weights the task was built with (from its
        own seed, 0 unless the caller chose another)."""
        self.task = task
        self.dm = datamodule
        self.config = config
        cc = config.custom_configs
        self.max_steps = int(max_steps if max_steps is not None
                             else cc.Training.get("max_steps", 200_000))
        self.limit_val_batches = int(
            limit_val_batches if limit_val_batches is not None
            else cc.Training.get("limit_val_batches", 5))
        # 0: validate once an epoch, as the reference
        self.val_check_interval = int(
            val_check_interval if val_check_interval is not None
            else cc.Training.get("val_check_interval", 0))
        self.log_every = int(log_every)
        self.seed = seed
        self.num_val_images = int(cc.Logging.get("num_val_images", 1))
        self.log_ndvi = bool(cc.Logging.get("log_ndvi", False))
        self.log_input_stats = bool(cc.Logging.get("log_input_stats", False))
        # batches prepared ahead on the feed's producer thread; 0 prepares
        # the next one in line
        self.prefetch_depth = int(tpu_section(config).get("prefetch_depth", 0))
        self._profile_dir = os.environ.get("NIRGAN_PROFILE_DIR")
        self._config_saved = False
        project = cc.Logging.get("wandb_project", "nirgan_tpu")

        # Model.load_checkpoint may name the run to resume (its dir, or a
        # last | best checkpoint inside it); an explicit path must resume
        lc = cc.Model.get("load_checkpoint")
        self._resume_which, self._resume_dir = "last", None
        if isinstance(lc, str) and lc:
            rd = lc.rstrip("/")
            name = os.path.basename(rd)
            if name in ("last", "best", "last.pt", "best.pt"):
                self._resume_which = name.split(".")[0]
                rd = os.path.dirname(rd)
            if not CheckpointManager.exists(rd, self._resume_which):
                raise FileNotFoundError(
                    f"load_checkpoint: no '{self._resume_which}' checkpoint "
                    f"under {rd!r}")
            self._resume_dir = rd
            if logdir is None:
                logdir = rd
        if logdir is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            logdir = os.path.join("logs", project, stamp)
        self.logdir = logdir
        self.logger = ExperimentLogger(logdir)
        self.ckpt = CheckpointManager(logdir, monitor=config.Schedulers.metric)
        sch = config.Schedulers
        # quirk kept: factor_g/factor_d are configured, the torch default
        # 0.1 is what runs in the reference (model/pix2pix.py:488-489)
        self.sched_g = ReduceLROnPlateau(patience=int(sch.patience_g))
        self.sched_d = ReduceLROnPlateau(patience=int(sch.patience_d))
        self.monitor = sch.metric
        self._preempted = False

    def _install_preemption_handler(self) -> None:
        """SIGTERM: checkpoint ``last`` at the next step boundary and return
        from ``fit`` so that a resume picks up there."""

        def handler(signum, frame):
            self._preempted = True
            print("SIGTERM received: checkpointing at the next step boundary",
                  flush=True)

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not in the main thread (e.g. under a test runner)

    # ----------------------------------------------------------------- state
    def _initial_state(self):
        state = self.task.init_state(seed=self.seed)
        cc = self.config.custom_configs
        if cc.Model.get("load_weights_only") and cc.Model.get("weights_path"):
            loaded = self.task.load_torch_weights(cc.Model.weights_path)
            for name in ("netG", "netD"):
                if name in loaded and getattr(self.task, name, None) is not None:
                    merge_state_dict(getattr(self.task, name), loaded[name])
            print(f"Loaded (only) weights from: {cc.Model.weights_path}")
        if cc.Model.get("load_checkpoint"):
            mgr = CheckpointManager(self._resume_dir or self.logdir)
            if mgr.restore(self.task, state, self._resume_which) is not None:
                print(f"Resumed full train state ({self._resume_which}) at "
                      f"step {state.step}")
                self._load_sched_state(mgr.directory)
        return state

    def _sched_state_path(self, which: str, directory=None) -> str:
        return os.path.join(directory or self.logdir, f"sched_state_{which}.json")

    def _save_sched_state(self, which: str = "last") -> None:
        blob = {key: {"best": s.best, "num_bad_epochs": s.num_bad_epochs,
                      "cooldown_counter": s.cooldown_counter}
                for key, s in (("g", self.sched_g), ("d", self.sched_d))}
        with open(self._sched_state_path(which), "w") as f:
            json.dump(blob, f)

    def _load_sched_state(self, directory: str) -> None:
        path = self._sched_state_path(self._resume_which, directory)
        if not os.path.exists(path):
            # runs of the JAX package before its per-kind files wrote one
            # un-suffixed file
            path = os.path.join(directory, "sched_state.json")
            if not os.path.exists(path):
                return
        with open(path) as f:
            blob = json.load(f)
        for sched, key in ((self.sched_g, "g"), (self.sched_d, "d")):
            s = blob.get(key, {})
            sched.best = s.get("best", sched.best)
            sched.num_bad_epochs = int(s.get("num_bad_epochs", 0))
            sched.cooldown_counter = int(s.get("cooldown_counter", 0))
        print(f"Restored plateau-scheduler state from {path}")

    # ------------------------------------------------------------------ fit
    def fit(self):
        """Train to ``max_steps``; returns the final ``TrainState``."""
        state = self._initial_state()
        self._install_preemption_handler()
        step_no = state.step
        epoch = 0
        batch_images = self.dm.train_batch_size
        t_window, n_window = time.perf_counter(), 0
        profiler = None
        try:
            while step_no < self.max_steps:
                feed = DeviceFeed(self.dm.train_dataloader(self.task.embed_coords),
                                  self.task.extract_batch, depth=self.prefetch_depth)
                for batch in feed:
                    if self._profile_dir and step_no == 10:
                        profiler = self._start_profiler()
                    metrics = self.task.train_step(state, batch)
                    step_no = state.step
                    n_window += batch_images
                    if profiler is not None and step_no == 20:
                        self._stop_profiler(profiler)
                        profiler = None
                    if step_no % self.log_every == 0:
                        m = _pull(metrics)
                        if not np.isfinite(m["model_loss/generator_total_loss"]):
                            raise RuntimeError(
                                f"non-finite generator loss at step {step_no}: {m}")
                        # NaN marks the train metrics the cadence skipped
                        m = {k: v for k, v in m.items()
                             if np.isfinite(v) or not k.startswith("train/")}
                        dt = time.perf_counter() - t_window
                        m["perf/images_per_sec"] = n_window / max(dt, 1e-9)
                        m["perf/step_ms"] = 1000.0 * dt / max(n_window / batch_images, 1)
                        m["lr/G"], m["lr/D"] = state.lr_g, state.lr_d
                        self.logger.log_metrics(m, step_no)
                        t_window, n_window = time.perf_counter(), 0
                    if (self.val_check_interval
                            and step_no % self.val_check_interval == 0):
                        self._run_validation(state, epoch + 1, step_no)
                    if self._preempted:
                        self.ckpt.save(self.task, state, {})
                        self._save_sched_state("last")
                        print(f"preemption checkpoint written at step {step_no}",
                              flush=True)
                        return state
                    if step_no >= self.max_steps:
                        break
                epoch += 1
                if not self.val_check_interval:
                    self._run_validation(state, epoch, step_no)
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
        return state

    def _start_profiler(self):
        """A ``torch.profiler`` window over the next steps (the JAX
        package's ``jax.profiler`` trace of steps 10-20)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.task.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Ends the window and writes its chrome trace into the profile
        directory."""
        profiler.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        print(f"profiler trace of steps 10-20 written to {path}", flush=True)
        self._profile_dir = None

    # ----------------------------------------------------------- validation
    def _log_val_images(self, batch, pred: torch.Tensor, step_no: int) -> None:
        """What one of the first ``num_val_images`` validation batches logs
        (``nirgan_tpu/train/trainer.py:426-475``), from the batch's first
        three channels and its NIR as the loader gave them and the
        prediction: the image panels (matplotlib's, or PIL's where it is not
        installed), the NDVI panels with ``log_ndvi``, the six ``val_stats/*`` with
        ``log_input_stats``, and the six ``indices_loss/*`` errors when the
        index losses are on."""
        rgb = np.asarray(batch["rgb"], np.float32)[:, :3]
        nir = np.asarray(batch["nir"], np.float32)
        pred_nchw = np.transpose(pred.float().cpu().numpy()[:len(rgb)], (0, 3, 1, 2))
        self.logger.log_image("Images/Val NIR",
                              plot_tensors_hist(rgb, nir, pred_nchw), step_no)
        if self.log_ndvi:
            self.logger.log_image("Images/Val NDVI",
                                  plot_index(rgb, nir, pred_nchw), step_no)
        if self.log_input_stats:
            self.logger.log_metrics({
                "val_stats/min_pred": pred_nchw.min(),
                "val_stats/max_pred": pred_nchw.max(),
                "val_stats/mean_pred": pred_nchw.mean(),
                "val_stats/min_input": nir.min(),
                "val_stats/max_input": nir.max(),
                "val_stats/mean_input": nir.mean(),
            }, step_no)
        if self.task.rs_losses is not None:
            def nhwc(a):
                return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 3, 1)

            d = self.task.rs_losses.get_and_weight_losses(
                nhwc(rgb), nhwc(nir), nhwc(pred_nchw), mode="logging_dict")
            self.logger.log_metrics({k: float(v) for k, v in d.items()}, step_no)

    def _run_validation(self, state, epoch: int, step_no: int) -> None:
        agg: dict = {}
        n_batches = 0
        for i, batch in enumerate(
                self.dm.val_dataloader(self.task.embed_coords)):
            if i >= self.limit_val_batches:
                break
            pred, metrics = self.task.eval_step(self.task.extract_batch(batch))
            for k, v in _pull(metrics).items():
                agg[k] = agg.get(k, 0.0) + v
            n_batches += 1
            if i < self.num_val_images:
                self._log_val_images(batch, pred, step_no)
        if n_batches == 0:
            return
        val = {k: v / n_batches for k, v in agg.items()}
        val["epoch"] = epoch
        self.logger.log_metrics(val, step_no)

        # config snapshot at the first validation (reference: epoch 1,
        # model/pix2pix.py:321-324)
        if not self._config_saved:
            save_config(self.config, os.path.join(self.logdir, "config.yaml"))
            self._config_saved = True

        monitored = val.get(self.monitor)
        if monitored is not None:
            cur_g, cur_d = state.lr_g, state.lr_d
            new_g = self.sched_g.step(monitored, cur_g)
            new_d = self.sched_d.step(monitored, cur_d)
            if new_g != cur_g or new_d != cur_d:
                print(f"ReduceLROnPlateau: lr G {cur_g:.2e}->{new_g:.2e} "
                      f"D {cur_d:.2e}->{new_d:.2e} at step {step_no}")
            state.set_lr(new_g, new_d)

        # scheduler counters after the checkpoints, so a crash between the
        # two leaves the previous consistent pair; 'best' counters only with
        # a new best checkpoint
        improved = self.ckpt.save(self.task, state, val)
        if monitored is not None:
            self._save_sched_state("last")
            if improved:
                self._save_sched_state("best")

        # the per-epoch geographic sweep (nirgan_tpu/train/trainer.py:410-423;
        # reference model/pix2pix.py:329-344): best-effort, never kills
        # training
        experimentation = self.config.custom_configs.get("experimentation") or {}
        if experimentation.get("save_val_df") and epoch >= 1:
            try:
                from nirgan_tpu_torch.validation.spider import (
                    spider_validation_callback,
                )

                spider_validation_callback(
                    self.task, self.dm.val_ds, satclip=self.task.satclip,
                    folder=self.logdir, epoch_no=epoch)
            except Exception as e:
                print("Error in spider callback validation and saving:", e)
                traceback.print_exc()
