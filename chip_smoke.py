"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits non-zero and
never prints the final ``"ok": true`` line:

0. device: a CUDA card is required; prints ``nvidia-smi`` name and power
   limit.
1. build: compiles the hand-written kernels (``nirgan_tpu_torch/csrc``).
2. kernels: each kernel against its plain PyTorch version, f32 and bf16,
   with the time of both, of the one PyTorch call that computes the same
   function where there is one (``library_ms``; the port never calls it)
   and the least time the card could take (``bound_ms``): the forward
   kernels at the serving path's shapes (batch 4 of 512^2 tiles padded to
   532^2), and every kernel at the train step's, at the batch of both
   train configs (16 and 8 of 256^2 tiles padded to 276^2; the instance
   norm at all six, C = 512 included, with the ReLU and the skip fused and
   not, at odd shapes on either side of its two regimes, and B and B4 at
   the seven norm shapes of the unet_256 step, 128^2 x 64 to 2^2 x 512).  The trunk conv is timed in both pad modes.  The
   instance norm is timed over a rotation of inputs larger than the L2
   cache (``ms``) and on one input (``warm_ms``).  The trunk conv and the
   transposed conv's backward are also held at a shape that their wgmma
   kernels do not take, where the WMMA kernels run.  The int8 trunk's
   kernels D (conv with moments) and E (norm from moments, four modes) at
   the serving trunk's shape (4, 133^2, 256) and at odd shapes, D timed
   beside kernel A at its shape; D in its other gathers (the replicate and
   zero borders, and stride 2 with the zero border at odd and even sides)
   exact against its plain version, timed at (4, 133^2, 256) beside the
   reflect gather and kernel A's ``pad=0``, and at stage 2's d1 (4, 266^2,
   128) -> 256 beside cuDNN's strided conv and kernel B.
3. generator: the full-width ``resnet_9blocks`` (ngf 64), random weights
   from a seed, batch 4 at 532^2 in bf16: kernel path against the plain
   path, launches per forward, forward time; then ``predict_step`` in f32
   on the card against the same task on the CPU.  Twice: the plain
   generator, then the SatCLIP inject generator with embeddings and
   ``predict_step`` with coordinates.  Then the int8 serving forward of
   both generators, the trunk calibrated on the batch: D and E's launches,
   against their plain versions >= 40 dB, against the bf16 forward within
   1 dB of the method's own error on the plain versions, a second forward
   bit for bit, its time beside the float forward's; the same with stage 2
   (d1 in int8: D 19, E 20 a forward, timed beside the trunk-only forward
   and the bf16 one with their dB) and with the replicate and zero trunks,
   D and E counted by gather and mode.
   The serving export (``phase_export``): the bf16 plain, inject and int8
   programs of 4 x 512^2 exported with ``torch.export``
   (``nirgan_tpu_torch.inference.export``), each against the live
   ``g_apply`` bit for bit, with the same launches a forward (18 A, 23 B,
   1 C; int8 18 D, 19 E, 5 B, 1 C) and its CUDA-event ms beside the live
   forward's; then loaded and run in a process that imports only
   ``nirgan_tpu_torch.ops`` and the export module (bit for bit again, no
   model, task or config module, no jax); and the host microseconds a call
   of an operator at a tiny shape, registered four ways.
   Scene serving (``inference/scene.py``, bf16, 512^2 windows at overlap
   32, batch 32, on the card by ``Px2PxTask``'s default device): a seeded
   3000 x 4000 uint16 scene with UTM metadata (63 windows, the last row
   and column clamped, a ragged tail) against the plain route (>= 40 dB)
   and bit for bit twice, wrapper calls 18 / 23 / 1 a window batch; the
   same with the int8 trunk (D 18 / E 19 a batch, against D and E's plain
   versions >= 40 dB and against bf16 within 1 dB of the plain versions'
   own error, bit for bit twice); the inject route of
   ``config_px2px_SatCLIP.yaml`` with one embedding a window (>= 40 dB,
   two distant windows' embeddings differ); f32, two windows, card against
   CPU (<= 1e-3); then a Sentinel-2-sized 10980^2 scene made in memory
   (625 windows): windows/s by CUDA events, peak device memory, wrapper
   calls.  ``python -m nirgan_tpu_torch.synthesize_scene`` (its ``main``)
   on a written 3000 x 4000 deflate GeoTIFF with ``--quant int8`` and
   ``--match-histogram``: the grid round-trips, the values equal the
   in-process scene followed by ``histogram_match``, the wall time split
   is printed, no jax in the process.
4. serving: ``python -m nirgan_tpu_torch.create_synthetic_dataset`` on 64
   seeded uint16 tiles (HR 512^2 3-band, LR 128^2 4-band, coordinates)
   with ``--device cuda --batch-size 4``; launch counts of that run,
   output checks, agreement with the plain path, and tiles/s of a warm
   rerun of the CLI.  Twice: ``config_px2px.yaml``, then
   ``config_px2px_SatCLIP.yaml``; then ``config_px2px.yaml`` with
   ``--quant int8``.
5. train: one fused GAN step of the full-width config in bf16 on the
   kernels against the plain route, launches per step, a finite non-zero
   gradient for every parameter, the same gradients bit for bit from a
   second run of the seeded step, the same step fed through
   ``DeviceFeed`` at depth 0 and 1 bit for bit, step times, bare, with
   ``extract_batch`` (the batch's pinned, asynchronous copies; the SatCLIP
   tower in line and ahead of time, as the trainer's loader thread runs
   it) and over 8 steps fed through ``DeviceFeed`` at depth 0 and 1; an
   f32 step on the card against the same seeded step on the CPU at a small
   config (the loss terms, D's gradients and its parameters after the
   update element by element, the G GAN term once the elements that Adam
   moved the other way are set to the CPU's, a step at LR 0, and three runs
   of the card's step bit for bit, timed with cuDNN's deterministic
   algorithms and without); then
   ``python -m nirgan_tpu_torch.train`` for 8 steps on the fake data
   (``last`` and ``best``) and a resume for 2 more.  Twice:
   ``config_px2px.yaml`` (batch 16 at 256^2), then the flagship
   ``config_px2px_SatCLIP.yaml`` (inject, batch 8 at 256^2) with the CLI's
   default arguments (its ``save_val_df`` sweep at the epoch's end
   included).  Then the S2 datasets' configuration (``phase_train512``,
   ``config_px2px.yaml`` with ``dataset_type: S2_75k`` on 69 seeded uint16
   RGBN ``.npy`` tiles of 512^2): every kernel against its plain version
   at the 532^2 step's shapes (A at (16, 133^2, 256), B and B4 at the six
   norm shapes, B5 at u1 and u0, C at (16, 538^2, 64); >= 40 dB in bf16),
   timed beside its bound and library call; the trunk backward's reflect
   pad and its adjoint (``phase_reflect_pad``: bit for bit with the plain
   ops at (16, 133^2, 256) and (16, 69^2, 256) bf16, at odd shapes, H or
   W = 2 and in f32, each timed beside its byte bound); one step at batch
   16 (launches, the pads' 18 + 18 among them, gradients, bit for bit
   again, the plain route's terms), its ms and peak memory; the same step
   with the trunk backward's pads on the plain ops, every gradient and
   term bit for bit (``pads_in_step``); the f32 step card against the CPU
   at batch 2 of 512^2; the
   train CLI for one epoch and a validation at 512^2 on the Python loader
   and on the native reader.  Then the concat route (6 blocks): one forward and
   one step, kernels against the plain route.  One flagship step with the
   SSIM, histogram (EMD) and spectral-index losses on, against the plain
   route, ``emd_loss`` timed; ``config_px2px.yaml`` at ngf 16 / ndf 16,
   served and stepped once, where the trunk conv and the head take their
   library routes (whose counts must be 0 at the flagship widths
   everywhere else).  The inject and concat planes of a 64 x 96 map, f32,
   card against CPU.  One step of ``config_px2px.yaml`` with
   ``tpu.param_dtype: bfloat16``: launches, gradients, f32 parameters after
   the update, bit for bit from the seed, its first step's ms beside the
   f32-parameter config's.
   The model variants, at full width, bf16 over f32 params, seed 0:
   ``unet_256``, then ``unet_128`` (ngf 64, basic D, instance norm,
   unpadded; B 13 and 11 calls a forward, 22 and 20 a step): the serving
   forward of 4 x 512^2 against the plain route (>= 40 dB), twice bit for
   bit, B's 13 calls; ``predict_step`` in f32 card against CPU (<= 1e-3);
   one step at batch 16 of 256^2 (B and B4 22 calls each, every gradient,
   within 2% + 1e-3 of the plain route, bit for bit from the same seed).
   pix2pix, upstream's defaults (``unet_256``, batch norm, ``no_dropout:
   false``, vanilla GAN, lambda_L1 100, batch 16): two steps, the running
   statistics moved, step 1 bit for bit again, the eval-mode forward.
   ``resnet_9blocks`` with dropout, the replicate and zero trunks (kernel A
   in its ``pad=0`` mode; a forward and a step each, bit for bit) and the
   pixel D: one step each against the plain route; ``gradient_penalty``
   through a batch-norm D, card against CPU, and through the instance-norm
   ``basic`` and ``pixel`` Ds (B and B4 under ``create_graph``), card
   against an f64 evaluation on the CPU, beside the kernels after the plain
   forward and a control the check must reject, and on ``real`` the
   kernels within 1.5x the plain route's distance; the penalty step's ms,
   kernels against the plain route.  The baselines: ``python -m
   nirgan_tpu_torch.train --baseline y --max-steps 4`` (batch 32 of
   256^2), then a step and a forward of each of Linear_NIR, MLP_NIR and
   CNN_NIR.
   SatCLIP pretraining (``tasks/satclip_pretrain.py``; no kernel of the
   port's on this path: the JAX package runs it in XLA), f32 with
   PyTorch's defaults (cuDNN convs in TF32, matmuls in f32): the CLI's
   default model (CLIP ModifiedResNet-50, width 64, 4 bands at 256^2,
   embed 256, siren over L = 10 spherical harmonics) at batch 32 on
   ``FakeS2GeoDataset(mode="geo")``: 20 steps over 4 batches (the loss
   finite, lower over the last 4 steps than over the first 4, every batch-norm
   statistic moved, no kernel of A-E launched), the step's ms (CUDA events,
   the median of 3 rounds), images/s, peak memory, the same 20 steps from
   the same seed bit for bit, and, after every other phase, the step's
   device time by group under ``torch.profiler`` (busy and idle share);
   ``moco_resnet50`` and
   ``moco_vit16`` (13 bands at 256^2, batch 32): the frozen tower bit for
   bit, head and location network moved, the tower's statistics moved
   (ResNet), step ms; a reduced model (layers (1, 1, 1, 1), width 16,
   64^2, batch 8) in f32 with TF32 off, one step card against CPU (loss,
   gradients, embeddings); ``python -m nirgan_tpu_torch.pretrain_satclip
   --fake-geo --steps 20`` and its run directory as ``satclip_path`` of a
   ``config_px2px_SatCLIP.yaml`` ``Px2PxTask`` that trains a step and
   serves a batch, the wrapper's embeddings against the pretrain task's
   ``location_encoder``.
   The validation tools (``phase_validation``, bf16 over f32 params, seed
   0): ``python -m nirgan_tpu_torch.validate`` in a process of its own on
   ``config_px2px.yaml`` with a fake val split of 64 256^2 samples with
   coordinates: the CSV's 64 rows and the GeoJSON's 64 features, the
   example panels of samples 0 and 50, every metric finite, the Köppen and
   continent joins on the shipped layers, no jax in that process.  The
   same sweep in process (the head's bias at 1 and its weight x0.1, so the
   NIR lies in (0, 1) and the index columns are away from their poles):
   A 18, B 23, C 1 a batch of 8; against the plain route (predictions >=
   40 dB, metrics within 1e-2, PSNR 0.1 dB), again bit for bit; samples/s
   by the host's clock beside the forward's and the metric program's
   device ms; with the int8 trunk (D 18, E 19 a batch, PSNR within 1 dB of
   the bf16 sweep's) and the CLI's ``--quant int8``; ``--compare`` with the
   flagship (three radar plots); f32, two batches at 64^2, card against
   CPU (<= 1e-3); the flagship train CLI with its ``save_val_df`` for two
   epochs (the e1 and e2 GeoJSONs, its launches); its ``last.pt``
   through ``python -m nirgan_tpu_torch.export_torch_ckpt`` and
   ``load_reference_weights``, served bit for bit as the trained G.
   The native tile reader (``phase_native``): ``csrc/tileio.cc`` built by
   ``g++`` with the codecs whose headers the machine has (a tile in a
   codec left out must raise naming it), a seeded folder of 256 4 x 256^2
   tiles (``.npy`` and deflate, zstd and lzw GeoTIFFs) read by it and by
   the Python ``Loader``, each tile within one f32 step of the other by
   index, and ``config_px2px.yaml`` fed from the folder on both routes in
   turns (images/s; the card's idle share under the profiler at the end).
   Data parallelism (``phase_ddp``): two processes on the card over gloo
   against one on the global batch (three bf16 steps within 2% + 1e-3,
   the f32 step by ``check_f32_step``'s rule), the train CLI under
   ``torch.distributed.run`` over NCCL at world size 1 bit for bit with the
   CLI without a process group, the scene CLI in two row bands and the
   serving CLI with ``--mesh`` bit for bit with one process.
   Spatial sharding (``phase_spatial``): the new kernel entry points
   against their plain versions at the 2048^2 tile's shard shapes (B's
   split forward, D's VALID gathers and f64 sums, E with the tile's
   count); one seeded 2048^2 tile of ``config_px2px.yaml`` through
   ``predict_large_tile`` on two processes sharing the card over gloo,
   against one process's ``g_apply`` in bf16 (>= 40 dB), with the int8
   trunk and stage 2 (JAX's bounds), each rank's wrapper calls, peak
   memory and forward ms; f32 with TF32 off in three trunks (<= 1e-4),
   also under ``torch.distributed.run`` over NCCL at world size 1; the
   (2, 2) grid over four processes (>= 40 dB).  The same for ``unet_256``
   at full width: the 2048^2 tile over two processes in bf16 (>= 40 dB;
   B's split forward for all 13 norms; its |d| by row, each layer of each
   rank against one process's, each layer alone on its own input at
   2048^2 and 512^2 with the cuDNN kernels of the first that parts, and in
   f32 <= 1e-4) and with pix2pix's batch norm, f32
   512^2 over four (<= 1e-4; the innermost block on the gathered map, B's
   one call) and under torchrun, the (2, 2) grid; B's split forward at the
   U-Net's shard shapes over two and four shards.
6. launches: one call of the instance norm at each timed shape under
   ``torch.profiler``: one kernel where the plan is resident, two where it
   streams.  Then the 10980^2 scene's window loop under the profiler: its
   device busy time against the span read before (the card's idle share),
   the same loop with a generator that only takes a channel (what the cut
   and the blend cost), and the host's waits on the card in the loop and
   in one ``extract_batch`` (none may happen).  Last, since an attached
   profiler slows the host's launches.

``python3 chip_smoke.py --profile`` instead prints, after phases 0 and 1,
the device time of the serving forward (also with the int8 trunk) and of
the train step by group of kernels under ``torch.profiler``, on the plain and on the inject route
(the plain route's step also at batch 16 of 512^2 tiles, 532^2),
the head's backward on its own (also at (16, 538^2, 64)) and the full-width SatCLIP pretrain step
(no checks, no ``ok`` line).
``python3 chip_smoke.py --sweep`` instead times the instance norm under
every launch plan its kernels take at the main path's shapes, beside the
plan that ``launch_plan`` chooses.
``python3 chip_smoke.py --phase NAME [NAME ...]`` runs, after phases 0 and
1, only the named phases (``ALONE``: int8, train, variants, nonsquare,
param_dtype, export, native, ddp, spatial, train512, unet, reflect_pad,
and profiler:
the windows in which the profiler counted no kernel of a call, with
``device_launches``' margin and without it), with no JSON lines: a phase's
checks read without what the phases before it leave set.
``python3 chip_smoke.py --times DIR`` times, after phases 0 and 1 run on
the package of the checkout at DIR (a parent commit's, unpacked), kernel B
at two shapes, the bf16 forward, the batch-16 step, the instance norm's
host cost a call, kernel D at its four timed gathers, kernel A at three
shapes, kernel E in its four modes and with a shard's count (each beside a
sha256 of its outputs) and the int8 forward, profiled last
(``phase_times``): run it for two checkouts in turns in one call to
compare them on one card.
``python3 chip_smoke.py --split DIR [D] [E]`` times kernel D's wgmma kernel
and kernel E of the checkout at DIR rebuilt with parts of their work cut
out (``phase_split``; both by default).

Before the last line it prints one JSON object with every kernel's route,
source, launches in the training CLI's run (``per_step``: in one fused
step), error, and times and bound at the train step's ``shape``; a forward
kernel's ``serving`` entry holds the serving path's shape, times, bound and
launches (``per_forward``: in one generator forward); every kernel's
``scene`` entry its wrapper calls in the 10980^2 scene's run (D's and
E's: the 3000 x 4000 int8 scene's), every kernel's
``validation`` entry (A, B, C; D and E from the int8 sweep) its launches
in the validation sweep of 64 samples and per batch of 8, every kernel's
``export`` entry its launches in one forward of each exported program (the
line's ``export`` holds the exported and live forwards' ms, ``host_us``
the operators' host cost a call), every kernel's
``satclip`` entry holds its launches on the SatCLIP inject route (the
training CLI's default run, one step, the serving CLI, one forward) and its
``satclip_step`` entry (``satclip_u1`` / ``satclip_u0`` for the transposed
conv's backward) its times, bound and plan at that route's batch of 8; the
head's entries state the kernel that ran, the time of the f32-FMA kernel it
replaced (``old_ms``), the two-call library route and ``share`` =
``bound_ms / ms``; the trunk conv's
``pad0`` entries hold its times on a pre-padded input, and the
``trunk_conv_pad0`` entry its calls on the replicate and zero trunks;
the ``reflect_pad`` and ``reflect_pad_adjoint`` entries (the trunk
backward's pad and its adjoint) their times and byte bound at the 532^2
step's trunk shape, ``train276`` at the 276^2 step's, and
``train512_step`` their launches in one 532^2 step beside the 18 wanted;
the instance norm's ``unet`` and ``unet_128`` entries its calls in the
unet_256 and unet_128 forward and step, and ``unet_shapes`` (and
``unet_128_shapes``) its times at the U-Net's shapes; every kernel's
``train512_step`` entry its launches in one 532^2 step, and its
``train512*`` entries its times at that step's shapes (the line's
``train512`` holds the step's ms, peak and the CLI's rates); the instance norm's
entries state their launch plan (``regime``, ``cluster``, ``smem_bytes``)
and the kernels that one call launched on the card under ``torch.profiler``
(``cuda_launches``), and list every main-path shape under ``shapes``,
the forward also with the skip fused (``with_skip``), the backward also
without the fused ReLU (``no_relu`` at 69^2, ``no_relu_276`` at 276^2,
beside the library call).  D's and E's entries hold the int8 serving CLI's
launches (two batches of 4), ``per_forward`` and their times at the serving
trunk's shape (E by mode); ``int8_conv_replicate``, ``int8_conv_zero``,
``int8_conv_stride2`` and ``int8_norm_mode3`` hold D's other gathers and
E's mode 3 with their launches in the int8 forward that runs them.  The
line also carries ``stage2`` (the int8 forward with and without it) and
``bf16_params`` (the first step's ms), ``native`` (the reader's images/s
on both routes, its build, codecs and idle shares) and ``ddp`` (the
processes' step ms beside one process's, the banded scene's wall) and
``spatial`` (the sharded tile's dB, max |d|, peak memory, ms and
wrapper calls a rank beside one process's); the H-sharded tile's entry
points (``instance_norm_sums``, ``instance_norm_apply``,
``int8_conv_valid``, ``int8_conv_stride2_valid``, ``int8_norm_count``)
are kernel entries of their own with their calls in a rank's sharded
forward; B's three entries' ``spatial_unet`` their calls in a rank's
sharded unet_256 forward (over two and over four), the split entries'
``unet_shapes`` their times at the U-Net's shard shapes.  The
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "config_px2px.yaml")
SATCLIP_CONFIG = os.path.join(ROOT, "configs", "config_px2px_SatCLIP.yaml")
BATCH = 4
TILE, LR_TILE, PAD = 512, 128, 10
SIDE = TILE + 2 * PAD  # 532: the generator's input side at serving
TRAIN_BATCH, TRAIN_TILE = 16, 256
SATCLIP_BATCH = 8  # the train batch of config_px2px_SatCLIP.yaml
TRAIN_SIDE = TRAIN_TILE + 2 * PAD  # 276: the generator's input side in training
SEED = 0
SERVE_TILES = 64  # tiles the serving CLI writes in each of its runs
# kernel launches of one fused train step of the full-width config: 18
# trunk convs; 23 G norms + 3 D forwards x 3 norms; the backward of each
# norm the step differentiates (G 23, D 6 for the D loss, D 3 for the G
# loss); one head; the u0 and u1 transposed convs
SERVING_KERNELS = ("trunk_conv", "instance_norm", "head_conv")
STEP_LAUNCHES = {"trunk_conv": 18, "instance_norm": 32, "instance_norm_bwd": 32,
                 "head_conv": 1, "convt_bwd": 2}
# and of one eval forward
EVAL_LAUNCHES = {"trunk_conv": 18, "instance_norm": 23, "instance_norm_bwd": 0,
                 "head_conv": 1, "convt_bwd": 0}

RESULTS: dict = {}  # kernel name -> its JSON entry
STAGE2: dict = {}  # the full-width int8 forward with and without stage 2
PENALTY_LAUNCHES: dict = {}  # B and B4 under gradient_penalty, by D
INT8_ROUTES: dict = {}  # D's launches by gather and E's by mode, an int8 forward
# the int8 serving trunk's kernels and their wrapper calls a forward of the
# 9-block generator: D twice a block, E once to quantise the trunk's input
# and twice a block
INT8_FORWARD = {"int8_conv": 18, "int8_norm": 19}
# published peaks of one H100 SXM: dense bf16 and int8 tensor-core rates and
# the HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, run_ahead: bool = False) -> float:
    """Mean time of one call, from CUDA events around ``iters`` calls after
    ``warmup`` (a whole round of them and one more where ``fn`` rotates its
    inputs: a round's results stay alive while the next call allocates its
    own, so only then does every buffer exist): the larger of what the card
    and what the host take for a call.  With ``run_ahead`` (the single kernels) the card
    first spins for a few milliseconds, so the host has the calls queued
    when the clock starts and a wrapper's host time does not pass for
    device time.  The whole forward and the whole step are timed without
    it: there the host's time is part of what a user waits for."""
    for _ in range(max(warmup, getattr(fn, "rounds", -1) + 1)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_ms(*fns, iters: int = 20, run_ahead: bool = False) -> tuple:
    """The times of the given functions (kernel, plain, and the library
    call where there is one; None stays None) taken in turns, forth and
    back (kernel, plain, plain, kernel) and averaged, so drift on the card
    weighs on all alike."""
    def one(fn):
        return time_ms(fn, iters, run_ahead=run_ahead) if fn else None

    forth = [one(fn) for fn in fns]
    back = [one(fn) for fn in reversed(fns)][::-1]
    return tuple((a + b) / 2 if a is not None else None
                 for a, b in zip(forth, back))


def least_time(flops: float, moved: float,
               peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the tensor cores' peak for their type (bf16
    unless ``peak`` says otherwise) and the bytes that must move (each input
    read once, each output written once) over the memory rate."""
    by_ops, by_bytes = flops / peak * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernels():
    from nirgan_tpu_torch.ops import convt_bwd, head_conv, instance_norm, trunk_conv

    return {"trunk_conv": trunk_conv.trunk_conv_cuda,
            "instance_norm": instance_norm.instance_norm_cuda,
            "instance_norm_bwd": instance_norm.instance_norm_bwd_cuda,
            "head_conv": head_conv.head_conv_cuda,
            "convt_bwd": convt_bwd.convt_k3s2_bwd_cuda}


def int8_kernels():
    from nirgan_tpu_torch.ops import int8_trunk

    return {"int8_conv": int8_trunk.conv_moments_cuda,
            "int8_norm": int8_trunk.norm_quant_cuda}


def library_routes():
    """The library routes of the ops whose kernels are built for some widths
    only: their calls are counted apart from the kernels'."""
    from nirgan_tpu_torch.ops import head_conv, trunk_conv

    return {"trunk_conv_library": trunk_conv.trunk_conv_library,
            "head_conv_library": head_conv.head_conv_library}


def pad_kernels():
    """The trunk backward's reflect pad and its adjoint."""
    from nirgan_tpu_torch.ops import reflect_pad

    return {"reflect_pad": reflect_pad.reflect_pad_cuda,
            "reflect_pad_adjoint": reflect_pad.reflect_pad_adjoint_cuda}


# a step of a 9-block reflect trunk: one pad and one adjoint a trunk conv
PAD_STEP_LAUNCHES = {"reflect_pad": 18, "reflect_pad_adjoint": 18}


def pad_counts() -> dict:
    return {name: fn.launches for name, fn in pad_kernels().items()}


def split_norm_kernels():
    """B's split forward, the H-sharded tile's instance norm."""
    from nirgan_tpu_torch.ops import instance_norm

    return {"instance_norm_sums": instance_norm.instance_norm_sums_cuda,
            "instance_norm_apply": instance_norm.instance_norm_apply_cuda}


def reset_counts() -> None:
    for table in (kernels(), int8_kernels(), library_routes(), split_norm_kernels(),
                  pad_kernels()):
        for fn in table.values():
            fn.launches = 0
    for fn in int8_kernels().values():
        getattr(fn, "by_gather", getattr(fn, "by_mode", {})).clear()
    getattr(kernels()["trunk_conv"], "by_pad", {}).clear()


def int8_by_route() -> dict:
    """D's launches by gather and E's by mode since the last reset."""
    d, e = int8_kernels().values()
    return {"int8_conv": {f"{b} s{st}": n for (b, st), n in d.by_gather.items()},
            "int8_norm": {f"mode {m}": n for m, n in sorted(e.by_mode.items())}}


def counts() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}


def int8_counts() -> dict:
    return {name: fn.launches for name, fn in int8_kernels().items()}


def library_counts() -> dict:
    return {name: fn.launches for name, fn in library_routes().items()}


def no_library(what: str) -> None:
    """The flagship widths are the kernels' own: no call may take a library
    route."""
    taken = library_counts()
    if any(taken.values()):
        raise AssertionError(f"{what}: a library route ran at the flagship widths: "
                             f"{taken}")


@contextlib.contextmanager
def int8_plain_route():
    """Kernels D and E's plain versions in place of the kernels, every
    other kernel as it is: the int8 trunk's own route against its kernels
    on the same input stream."""
    from nirgan_tpu_torch.ops import int8_trunk

    with mock.patch.object(int8_trunk, "conv_moments_cuda",
                           int8_trunk.conv_moments_plain), \
         mock.patch.object(int8_trunk, "norm_quant_cuda",
                           int8_trunk.norm_quant_plain):
        yield


@contextlib.contextmanager
def plain_pads():
    """The trunk backward's pad and adjoint on their plain versions (the
    ops they replace), every other kernel as it is."""
    from nirgan_tpu_torch.ops import reflect_pad

    with mock.patch.object(reflect_pad, "reflect_pad_cuda", reflect_pad.reflect_pad_plain), \
         mock.patch.object(reflect_pad, "reflect_pad_adjoint_cuda",
                           reflect_pad.reflect_pad_adjoint_plain):
        yield


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors to the plain versions instead of the kernels, to
    compare whole paths (the package itself has no such switch)."""
    from nirgan_tpu_torch.ops import (
        convt_bwd,
        head_conv,
        instance_norm,
        int8_trunk,
        trunk_conv,
    )

    with mock.patch.object(trunk_conv, "trunk_conv_cuda",
                           trunk_conv.trunk_conv_plain), \
         mock.patch.object(int8_trunk, "conv_moments_cuda",
                           int8_trunk.conv_moments_plain), \
         mock.patch.object(int8_trunk, "norm_quant_cuda",
                           int8_trunk.norm_quant_plain), \
         mock.patch.object(instance_norm, "instance_norm_cuda",
                           instance_norm.instance_norm_plain), \
         mock.patch.object(instance_norm, "instance_norm_bwd_cuda",
                           instance_norm.instance_norm_bwd_plain), \
         mock.patch.object(head_conv, "head_conv_cuda",
                           head_conv.head_conv_plain), \
         mock.patch.object(convt_bwd, "convt_k3s2_bwd_cuda",
                           convt_bwd.convt_k3s2_bwd_plain), \
         plain_pads():
        yield


def psnr(a: torch.Tensor, b: torch.Tensor, peak_to_peak: float) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak_to_peak ** 2 / mse)


# ------------------------------------------------------------------ phases
def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    print(smi_line(), flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    log("device", f"{dev['kind']} x{dev['count']}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return dev


def phase_build(instructions: bool = True) -> None:
    """Build the kernels, refuse any spill and, with ``instructions`` (not
    for ``--times`` or ``--split`` on another checkout, whose kernels may
    have other names), require each wgmma and mma.sync kernel's
    tensor-core instruction."""
    from nirgan_tpu_torch.ops import _lib

    path, seconds, report = _lib.build()
    _lib.library()
    log("build", f"{path.name} built in {seconds:.1f} s")
    entry_name = ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry_name = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            log("build", f"{entry_name[:90]}: {line.strip()}")
    spills = [line for line in report.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")
    if not instructions:
        return
    # the redesigned kernels must reach the tensor cores through wgmma:
    # HGMMA is its machine instruction in bf16, IGMMA in s8
    dump = subprocess.run(
        [os.path.join(os.path.dirname(_lib.nvcc()), "cuobjdump"), "-sass", str(path)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    per_kernel, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and any(op in line for op in ("HGMMA", "IGMMA", "HMMA.", "IMMA.")):
            op = next(op for op in ("HGMMA", "IGMMA", "HMMA", "IMMA") if op in line)
            per_kernel[(name, op)] = per_kernel.get((name, op), 0) + 1
    found = {f"{want} {op}": sum(v for (k, o), v in per_kernel.items()
                                 if want in k and o == op)
             for want, op in (("igemm_wgmma_kernelILi256", "HGMMA"),
                              ("igemm_wgmma_kernelILi128", "HGMMA"),
                              ("convt_dw_wgmma_kernel", "HGMMA"),
                              # the head's mma.sync is HMMA.16816
                              ("head_conv_mma_kernel", "HMMA"),
                              # D: the s8 kernel of the engine at both widths,
                              # and mma.sync s8
                              ("igemm_s8_kernelILi256", "IGMMA"),
                              ("igemm_s8_kernelILi128", "IGMMA"),
                              ("int8_conv_kernel", "IMMA"))}
    log("build", f"tensor-core instructions (wgmma = HGMMA, s8 wgmma = IGMMA, "
        f"mma.sync = HMMA, s8 mma.sync = IMMA): {found}")
    if not all(found.values()):
        raise AssertionError(f"a kernel without its tensor-core instruction: {found}")


def entry(name: str, source: str, replaces: str, err: float, train: tuple,
          serving: tuple | None = None, **others: tuple) -> dict:
    """A kernel's JSON entry.  ``train`` and ``serving`` are (shape, ms,
    plain_ms, library_ms, (bound_ms, bound_by)[, extra]), the arguments of
    ``times``.  The top-level times are at
    the train step's shape, since ``launches`` are the training CLI's; the
    serving path's shape, times and bound sit under ``serving``, beside that
    run's launches, and a further train shape under its own name."""
    out = dict(name=name, route="cuda", source=f"nirgan_tpu_torch/csrc/{source}",
               replaces=replaces, max_abs_err=err, **times(*train))
    if serving is not None:
        out["serving"] = times(*serving)
    out.update({key: times(*val) for key, val in others.items()})
    return out


def times(shape, ms, plain_ms, library_ms, bound_, extra=None) -> dict:
    """The timed part of a kernel's entry at one shape; ``extra`` holds
    what only some kernels state (a launch plan, ``warm_ms``)."""
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_[0], bound_by=bound_[1],
                library_ms=library_ms, shape=str(shape), **(extra or {}))


def check_trunk(g: torch.Generator, shape: tuple, co: int = 256,
                timed: bool = True) -> tuple:
    """Kernel A against its plain version on x of ``shape`` (B, H, W, Cin)
    with ``co`` output channels, f32 and bf16, both pad modes.  Returns the
    worst bf16 max |err| and, if ``timed``, the bf16 kernel, plain and
    library ms and the bound."""
    import torch.nn.functional as F

    from nirgan_tpu_torch.ops.pad import reflect_pad2d
    from nirgan_tpu_torch.ops.trunk_conv import (
        pack_weight,
        trunk_conv_cuda,
        trunk_conv_plain,
    )

    dev = torch.device("cuda")
    ci = shape[3]
    x = torch.randn(shape, device=dev, generator=g)
    w = torch.randn((co, ci, 3, 3), device=dev, generator=g) / (3 * math.sqrt(ci))
    b = torch.randn((co,), device=dev, generator=g) * 0.1
    worst = 0.0
    for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        # f32: 2304-term sums run in another order than cuDNN's, so
        # relative 1e-4; bf16: outputs are rounded to bf16 (2^-8) at
        # different points on the two sides, so relative 1e-2
        xd = x.to(dtype)
        ref = trunk_conv_plain(xd, w, b).float()
        scale = float(ref.abs().max())
        for pad, xin in ((1, xd), (0, reflect_pad2d(xd, 1))):
            got = trunk_conv_cuda(xin, w, b, pad=pad).float()
            err = float((got - ref).abs().max())
            rel = err / scale
            log("kernels", f"trunk_conv {dtype} {shape}->{co} pad={pad}: max|err| "
                f"{err:.3e}, relative {rel:.3e} (bound {bound:.0e})")
            if not rel <= bound:
                raise AssertionError(f"trunk_conv {dtype} {shape} pad={pad}: "
                                     f"{rel} > {bound}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    # the wrapper keeps a weight's kernel layout until the weight changes:
    # an in-place write, as an optimizer's, must reach the next launch
    xb = x.bfloat16()
    w.mul_(-0.5)
    ref = trunk_conv_plain(xb, w, b).float()
    rel = float((trunk_conv_cuda(xb, w, b).float() - ref).abs().max() / ref.abs().max())
    log("kernels", f"trunk_conv bf16 {shape}->{co} after an in-place write to the "
        f"weight: relative {rel:.3e} (bound 1e-02)")
    if not rel <= 1e-2:
        raise AssertionError(f"trunk_conv {shape}: a stale weight layout, {rel}")
    if not timed:
        return (worst,)
    # the library call: cuDNN's convolution on the input padded beforehand,
    # weight and bias already in bf16
    xp = reflect_pad2d(xb, 1).permute(0, 3, 1, 2)
    wb, bb = w.bfloat16().contiguous(memory_format=torch.channels_last), b.bfloat16()
    ms, plain_ms, lib_ms = compare_ms(lambda: trunk_conv_cuda(xb, w, b),
                                      lambda: trunk_conv_plain(xb, w, b),
                                      lambda: F.conv2d(xp, wb, bb), run_ahead=True)
    # the wrapper's call as the host paces it, and the weight's packing,
    # which a call pays only after the weight has changed
    paced_ms = time_ms(lambda: trunk_conv_cuda(xb, w, b))
    pack_ms = time_ms(lambda: pack_weight(w.bfloat16()), run_ahead=True)
    n, h, wd, _ = shape
    flops = 2 * n * h * wd * 9 * ci * co
    least = least_time(flops, nbytes(xb, w, b) + n * h * wd * co * 2)
    log("kernels", f"trunk_conv bf16 {shape}: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, F.conv2d on "
        f"the padded input {lib_ms:.4f} ms, bound {least[0]:.4f} ms ({least[1]}); "
        f"paced by the host {paced_ms:.4f} ms a call; packing a changed weight "
        f"{pack_ms:.4f} ms")
    # the VALID mode on an input padded beforehand (the counterpart of
    # conv3x3_pallas): the same kernel with pad=0, beside its plain version
    # and the same cuDNN call
    xpad = reflect_pad2d(xb, 1)
    ms0, plain0, lib0 = compare_ms(lambda: trunk_conv_cuda(xpad, w, b, pad=0),
                                   lambda: trunk_conv_plain(xpad, w, b, pad=0),
                                   lambda: F.conv2d(xp, wb, bb), run_ahead=True)
    least0 = least_time(flops, nbytes(xpad, w, b) + n * h * wd * co * 2)
    log("kernels", f"trunk_conv bf16 {tuple(xpad.shape)} pad=0: kernel {ms0:.4f} ms "
        f"({flops / ms0 / 1e9:.1f} TFLOP/s), plain {plain0:.4f} ms, F.conv2d "
        f"{lib0:.4f} ms, bound {least0[0]:.4f} ms ({least0[1]})")
    valid = (tuple(xpad.shape), ms0, plain0, lib0, least0)
    return worst, ms, plain_ms, lib_ms, least, valid


def check_head(g: torch.Generator, shape: tuple, timed: bool = True) -> tuple:
    """Kernel C against its plain version on x of ``shape`` (B, H, W, 64):
    f32 (the f32-FMA kernel) and bf16 (the mma.sync kernel).  Returns the
    bf16 max |err| and, if ``timed``, the bf16 kernel, plain and library ms,
    the bound, and what only the head states: the time of the f32-FMA
    kernel on the same bf16 input (``old_ms``), which kernel ran, and the
    share of the bound."""
    import torch.nn.functional as F

    from nirgan_tpu_torch.ops.head_conv import (
        _launch,
        head_conv_cuda,
        head_conv_plain,
        launch_plan,
    )

    dev = torch.device("cuda")
    x = torch.randn(shape, device=dev, generator=g)
    w = torch.randn((1, 64, 7, 7), device=dev, generator=g) / 56.0
    b = torch.full((1,), 0.1, device=dev)
    # f32: a 3136-term sum in another order, then tanh: abs 1e-5; bf16:
    # the plain side rounds conv, bias add and tanh, the kernel once:
    # abs 2^-6 (four bf16 steps near 1)
    for dtype, bound in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        xd = x.to(dtype)
        err = float((head_conv_cuda(xd, w, b).float()
                     - head_conv_plain(xd, w, b).float()).abs().max())
        log("kernels", f"head_conv {dtype} {shape}: max|err| {err:.3e} "
            f"(bound {bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"head_conv {dtype} {shape}: {err} > {bound}")
    if not timed:
        return (err,)
    xb = x.bfloat16()
    # the f32-FMA kernel still takes bf16 (it is the yardstick below): held
    # to the same bound
    old = float((_launch(xb, w, b, False).float()
                 - head_conv_plain(xb, w, b).float()).abs().max())
    if not old <= 2 ** -6:
        raise AssertionError(f"head_conv f32-FMA kernel on bf16 {shape}: {old}")
    # the closest library route, two calls (no single PyTorch call is conv
    # + bias + tanh): cuDNN's convolution with the bias on the channels-last
    # view of the padded input, weight and bias already in bf16, then tanh
    xn = xb.permute(0, 3, 1, 2)
    wb = w.bfloat16().contiguous(memory_format=torch.channels_last)
    bb = b.bfloat16()
    ms, plain_ms, lib_ms, old_ms = compare_ms(
        lambda: head_conv_cuda(xb, w, b), lambda: head_conv_plain(xb, w, b),
        lambda: torch.tanh(F.conv2d(xn, wb, bb)),
        lambda: _launch(xb, w, b, False), run_ahead=True)
    n, h, wd, c = shape
    least = least_time(2 * n * (h - 6) * (wd - 6) * 49 * c,
                       nbytes(xb, w, b) + n * (h - 6) * (wd - 6) * 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = launch_plan(n, h - 6, wd - 6, sms)
    log("kernels", f"head_conv bf16 {shape}: mma.sync kernel {ms:.4f} ms "
        f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}; "
        f"runs of {rows} rows), the f32-FMA kernel it replaced {old_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, F.conv2d + torch.tanh (two calls) {lib_ms:.4f} ms")
    extra = dict(kernel="mma.sync m16n8k16 on a Toeplitz weight, N = 8",
                 old_ms=old_ms, old_kernel="f32 FMA out of shared memory",
                 library="F.conv2d with bias, then torch.tanh: two calls, no "
                         "single call computes it",
                 share=least[0] / ms, rows_per_run=rows)
    return err, ms, plain_ms, lib_ms, least, extra


def check_head_odd(g: torch.Generator) -> None:
    """Kernel C at small odd shapes (a width that is no multiple of 8, one
    output row, one strip with a ragged end, a strip that just fits, two
    strips), the kept Toeplitz image after an in-place write to the weight,
    and the refusal of what the mma kernel does not take."""
    from nirgan_tpu_torch.ops.head_conv import _launch, head_conv_cuda, head_conv_plain

    for shape in ((2, 13, 21, 64), (1, 7, 9, 64), (2, 30, 47, 64),
                  (1, 23, 70, 64), (3, 40, 77, 64)):
        check_head(g, shape, timed=False)
    dev = torch.device("cuda")
    xb = torch.randn((2, 40, 77, 64), device=dev, generator=g).bfloat16()
    w = torch.randn((1, 64, 7, 7), device=dev, generator=g) / 56.0
    b = torch.full((1,), -0.2, device=dev)
    head_conv_cuda(xb, w, b)
    w.mul_(-0.5)  # as an optimizer writes: the next launch must see it
    err = float((head_conv_cuda(xb, w, b).float()
                 - head_conv_plain(xb, w, b).float()).abs().max())
    log("kernels", f"head_conv bf16 after an in-place write to the weight: "
        f"max|err| {err:.3e} (bound {2 ** -6:.3e})")
    if not err <= 2 ** -6:
        raise AssertionError(f"head_conv: a stale Toeplitz image, {err}")
    try:
        _launch(xb.float(), w, b, True)
    except RuntimeError as e:
        log("kernels", f"head_conv: the mma kernel refuses f32: {e}")
    else:
        raise AssertionError("head_conv: the mma kernel took an f32 input")


F32_U = 2.0 ** -24  # f32's unit roundoff


def few_pixel_f32_bound(x: torch.Tensor) -> torch.Tensor:
    """The f32 bound of kernel B against its plain version where an image
    has few pixels (the U-Net's 2^2 ... 8^2 norms): both compute mean and
    E[x^2] over n pixels in f32, in other orders, each sum off by at most
    (n - 1) u of its terms' sum, and var = E[x^2] - E[x]^2 cancels, so
    y = (x - mean) r moves by up to r (n - 1) u mean|x| + |y| (n - 1) u
    E[x^2] / (var + eps), on each side; plus a rounding of y.  Never under
    the abs 1e-5 of the main path's shapes, where it is the smaller."""
    x64 = x.double()
    n = x.shape[1] * x.shape[2]
    mean = x64.mean(dim=(1, 2), keepdim=True)
    m2 = (x64 * x64).mean(dim=(1, 2), keepdim=True)
    var = m2 - mean * mean
    r = torch.rsqrt(var + 1e-5)
    y = (x64 - mean) * r
    k = (n - 1) * F32_U
    bound = 2 * (k * r * x64.abs().mean(dim=(1, 2), keepdim=True)
                 + k * y.abs() * m2 / (var + 1e-5)) + 4 * F32_U * y.abs()
    return bound.clamp(min=1e-5).float()


def few_pixel_f32_bwd_bound(x: torch.Tensor, g: torch.Tensor,
                            stats: torch.Tensor) -> torch.Tensor:
    """B4's f32 bound against its plain version at few pixels, on the same
    statistics: dx = r (g - mean(g) - y mean(g y)); the two means over n
    pixels in other orders differ by up to (n - 1) u of their terms' sums on
    each side, times r (and |y|); plus a rounding of dx.  Never under abs
    1e-5."""
    n = x.shape[1] * x.shape[2]
    mean = stats[:, 0, None, None, :].double()
    r = stats[:, 1, None, None, :].double()
    y = (x.double() - mean) * r
    g64 = g.double()
    k = (n - 1) * F32_U
    dx = r * (g64 - g64.mean(dim=(1, 2), keepdim=True)
              - y * (g64 * y).mean(dim=(1, 2), keepdim=True))
    bound = 2 * k * r * (g64.abs().mean(dim=(1, 2), keepdim=True)
                         + y.abs() * (g64 * y).abs().mean(dim=(1, 2), keepdim=True)) \
        + 4 * F32_U * dx.abs()
    return bound.clamp(min=1e-5).float()


def check_norm(x: torch.Tensor, relu: bool,
               residual: torch.Tensor | None = None,
               few_pixels: bool = False) -> float:
    """Kernel B against its plain version on f32 x and on x in bf16, with
    the skip fused where ``residual`` is given.  ``few_pixels`` holds the
    f32 comparison to ``few_pixel_f32_bound`` in place of abs 1e-5.
    Returns the bf16 max |err|."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )

    shape = tuple(x.shape)
    what = f"{shape} relu={relu} skip={residual is not None}"
    # f32: same formula, sums in another order: abs 1e-5
    diff = (instance_norm_cuda(x, relu=relu, residual=residual)
            - instance_norm_plain(x, relu=relu, residual=residual)).abs()
    err = float(diff.max())
    if few_pixels:
        rel = float((diff / few_pixel_f32_bound(x)).max())
        log("kernels", f"instance_norm f32 {what}: max|err| {err:.3e}, worst |err| / "
            f"bound {rel:.3f} (the few-pixel bound)")
        if not rel <= 1.0:
            raise AssertionError(f"instance_norm f32 {what}: {rel}")
    else:
        log("kernels", f"instance_norm f32 {what}: max|err| {err:.3e} (bound 1e-05)")
        if not err <= 1e-5:
            raise AssertionError(f"instance_norm f32 {what}: {err}")
    # bf16: both sides round mean, scale, x - mean and the product to bf16;
    # an f32 statistic summed in another order can round to the
    # neighbouring bf16 value, which moves x - mean and y by a step each:
    # |err| <= 2^-6 * (|y| + 1), four bf16 steps of y.  With the skip the
    # sum is rounded once more: another 2^-7 of it
    xb = x.bfloat16()
    rb = residual.bfloat16() if residual is not None else None
    y = instance_norm_plain(xb, relu=relu).float()
    ref = instance_norm_plain(xb, relu=relu, residual=rb).float()
    got = instance_norm_cuda(xb, relu=relu, residual=rb).float()
    err = (got - ref).abs()
    bound = 2 ** -6 * (y.abs() + 1)
    if residual is not None:
        bound = bound + 2 ** -7 * ref.abs()
    rel = float((err / bound).max())
    log("kernels", f"instance_norm bf16 {what}: max|err| {float(err.max()):.3e}, "
        f"worst |err| / bound {rel:.3f} (bound 2^-6 (|y| + 1)"
        f"{' + 2^-7 |sum|' if residual is not None else ''})")
    if not rel <= 1.0:
        raise AssertionError(f"instance_norm bf16 {what}: {rel}")
    if residual is not None:
        # the fused skip is the separate sum's two roundings, bit for bit
        for xd, rd in ((x, residual), (xb, rb)):
            if not torch.equal(instance_norm_cuda(xd, relu=relu, residual=rd),
                               rd + instance_norm_cuda(xd, relu=relu)):
                raise AssertionError(f"instance_norm {xd.dtype} {what}: the fused "
                                     "skip is not residual + norm(x) bit for bit")
    return float(err.max())


def check_norm_bwd(x: torch.Tensor, dy: torch.Tensor, relu: bool,
                   few_pixels: bool = False) -> float:
    """Kernel B4 against its plain version on f32 and bf16.  Both sides
    take the kernel's forward statistics, which ``check_norm`` holds against
    the plain forward.  f32: the same f32 formula with sums in another
    order: abs 1e-5.  bf16: both compute in f32 from the same bf16 inputs
    and round dx once, so where an f32 sum in another order straddles a
    rounding boundary the two differ by one bf16 step: |err| <= 2^-7 |dx|
    (+ 1e-5 for the f32 difference).  ``few_pixels`` puts
    ``few_pixel_f32_bwd_bound`` in place of both 1e-5.  The mask that B4
    takes from x must be the forward kernel's ``out > 0`` bit for bit.
    Returns the bf16 max |err|."""
    from nirgan_tpu_torch.ops.instance_norm import (
        _normalized,
        instance_norm_bwd_cuda,
        instance_norm_bwd_plain,
        instance_norm_cuda,
    )

    shape, worst = tuple(x.shape), 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xd, gd = x.to(dtype), dy.to(dtype)
        out, stats = instance_norm_cuda(xd, relu=relu, return_stats=True)
        if relu and not torch.equal(_normalized(xd, stats) > 0, out > 0):
            raise AssertionError(f"instance_norm_bwd {dtype} {shape}: the mask "
                                 "from x is not the forward's out > 0")
        ref = instance_norm_bwd_plain(xd, gd, stats, relu).float()
        got = instance_norm_bwd_cuda(xd, gd, stats, relu).float()
        err = (got - ref).abs()
        f32_part = (few_pixel_f32_bwd_bound(xd.float(), gd.float(), stats)
                    if few_pixels else 1e-5)
        part = "the few-pixel bound" if few_pixels else "1e-5"
        if dtype == torch.float32:
            ok = bool((err <= f32_part).all())
            bound = part if few_pixels else "abs 1e-5"
        else:
            ok = bool((err <= 2 ** -7 * ref.abs() + f32_part).all())
            bound = f"2^-7 |dx| + {part}"
            worst = float(err.max())
        log("kernels", f"instance_norm_bwd {dtype} {shape} relu={relu}: "
            f"max|err| {float(err.max()):.3e} (bound {bound})")
        if not ok:
            raise AssertionError(f"instance_norm_bwd {dtype} {shape} "
                                 f"relu={relu}: {float(err.max())}")
    return worst


# the inputs of one timed call are rotated over copies that together exceed
# this, so that no call finds its input in the 50 MB L2 cache
ROTATION_BYTES = 128 << 20


def rotation(*tensors: torch.Tensor) -> list:
    """Copies of ``tensors`` as a list of tuples, at least four, the first
    tensor's copies larger in sum than ``ROTATION_BYTES``."""
    n = max(4, -(-ROTATION_BYTES // nbytes(tensors[0])))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def rotating(fn, sets: list):
    """``fn(*sets[i])`` with i going round the sets from call to call, and
    with it the allocator's blocks for the results."""
    turn, kept = [0], [None] * len(sets)

    def call():
        turn[0] += 1
        i = turn[0] % len(sets)
        # the results stay alive for a round, so the outputs rotate too
        kept[i] = fn(*sets[i])
        return kept[i]
    call.rounds = len(sets)
    return call


def plan_facts(x: torch.Tensor, backward: bool) -> dict:
    """The launch plan of the instance norm on x, as the entry states it."""
    from nirgan_tpu_torch.ops.instance_norm import launch_plan, max_active_clusters

    b, h, w, c = x.shape
    plan = launch_plan(b, h * w, c, x.element_size(), backward)
    facts = dict(regime=plan.regime, group=plan.group, cluster=plan.cluster,
                 threads=plan.threads, smem_bytes=plan.smem_bytes,
                 slabs=plan.slabs)
    if plan.regime == "resident":
        facts["max_active_clusters"] = max_active_clusters(x, plan, backward)
    return facts


def norm_times(xb: torch.Tensor, relu: bool, skip: bool = False) -> tuple:
    """bf16 kernel B, plain and library ms on rotated copies of xb (and of a
    residual, with ``skip``), the bound, and the plan with the kernel's time
    on one input (``warm_ms``).  The library call is ``F.instance_norm`` on
    the NCHW view: the norm alone, without the ReLU or the skip that the
    kernel fuses."""
    import torch.nn.functional as F

    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )

    sets = rotation(xb, torch.randn_like(xb)) if skip else rotation(xb)

    def call(fn):
        return rotating(lambda x, r=None: fn(x, relu=relu, residual=r), sets)

    ms, plain_ms, lib_ms = compare_ms(
        call(instance_norm_cuda), call(instance_norm_plain),
        rotating(lambda x, r=None: F.instance_norm(x.permute(0, 3, 1, 2), eps=1e-5),
                 sets), iters=10, run_ahead=True)
    warm_ms = time_ms(lambda: instance_norm_cuda(xb, relu=relu, residual=sets[0][-1]
                                                 if skip else None),
                      iters=10, run_ahead=True)
    # x (and the residual) read once, y written once; about 8 f32
    # operations an element
    least = least_time(0, (3 if skip else 2) * nbytes(xb))
    facts = plan_facts(xb, False)
    log("kernels", f"instance_norm bf16 {tuple(xb.shape)} relu={relu} skip={skip}: "
        f"kernel {ms:.4f} ms over {len(sets)} rotated inputs "
        f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}), "
        f"{warm_ms:.4f} ms on one input, plain {plain_ms:.4f} ms, F.instance_norm "
        f"{lib_ms:.4f} ms; plan {facts}")
    return ms, plain_ms, lib_ms, least, dict(warm_ms=warm_ms, relu=relu, skip=skip,
                                             **facts)


def bwd_times(xb: torch.Tensor, gb: torch.Tensor, relu: bool) -> tuple:
    """bf16 kernel B4, plain and library ms on rotated copies of x and the
    cotangent, the bound and the plan.  The library call, timed only without
    the ReLU (no single call masks too), is
    ``aten.native_batch_norm_backward`` on the (1, B C, H, W) view with the
    saved mean and inverse std: what autograd runs under
    ``F.instance_norm``."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_bwd_cuda,
        instance_norm_bwd_plain,
        instance_norm_cuda,
    )

    b, h, w, c = xb.shape
    _, stats = instance_norm_cuda(xb, relu=relu, return_stats=True)
    sets = rotation(xb, gb)
    library = None
    if not relu:
        mean, invstd = stats[:, 0].reshape(-1), stats[:, 1].reshape(-1)
        nchw = [tuple(t.permute(0, 3, 1, 2).contiguous().view(1, b * c, h, w)
                      for t in pair) for pair in sets]
        library = rotating(
            lambda x, g: torch.ops.aten.native_batch_norm_backward(
                g, x, None, None, None, mean, invstd, True, 1e-5,
                [True, False, False]), nchw)
    ms, plain_ms, lib_ms = compare_ms(
        rotating(lambda x, g: instance_norm_bwd_cuda(x, g, stats, relu), sets),
        rotating(lambda x, g: instance_norm_bwd_plain(x, g, stats, relu), sets),
        library, iters=10, run_ahead=True)
    warm_ms = time_ms(lambda: instance_norm_bwd_cuda(xb, gb, stats, relu),
                      iters=10, run_ahead=True)
    # the function needs x, the cotangent and the statistics in and dx out,
    # with or without the ReLU, whose mask follows from x and the statistics
    least = least_time(0, nbytes(xb, gb, stats) + nbytes(xb))
    facts = plan_facts(xb, True)
    log("kernels", f"instance_norm_bwd bf16 {tuple(xb.shape)} relu={relu}: kernel "
        f"{ms:.4f} ms over {len(sets)} rotated inputs ({least[0] / ms * 100:.0f}% of "
        f"the bound {least[0]:.4f} ms, {least[1]}), {warm_ms:.4f} ms on one input, "
        f"plain {plain_ms:.4f} ms, aten.native_batch_norm_backward "
        f"{'not timed' if lib_ms is None else f'{lib_ms:.4f} ms'}; plan {facts}")
    return ms, plain_ms, lib_ms, least, dict(warm_ms=warm_ms, relu=relu, **facts)


def phase_kernels() -> None:
    """Every kernel against its plain version: the forward kernels at the
    serving forward's shapes and at the train step's, the backward kernels
    at the train step's."""
    # f32 references must not round through TF32 in cuDNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)

    # --- A at the trunk's shape in serving and in training, at both train
    # configs' batch sizes (the batch sets the tile count and its ragged tail)
    serving = (BATCH, SIDE // 4, SIDE // 4, 256)
    train = (TRAIN_BATCH, TRAIN_SIDE // 4, TRAIN_SIDE // 4, 256)
    satclip = (SATCLIP_BATCH, TRAIN_SIDE // 4, TRAIN_SIDE // 4, 256)
    e1, *s_times, s_valid = check_trunk(g, serving)
    e2, *t_times, t_valid = check_trunk(g, train)
    e3, *c_times, c_valid = check_trunk(g, satclip)
    # bf16 shapes the wgmma kernel does not take run the WMMA kernel
    check_trunk(g, (2, 40, 40, 128), co=128, timed=False)
    check_trunk(g, (2, 40, 40, 32), co=256, timed=False)
    RESULTS["trunk_conv"] = entry(
        "trunk_conv", "trunk_conv.cu", "nirgan_tpu/ops/pallas_trunk.py:240",
        max(e1, e2, e3), (train, *t_times), (serving, *s_times),
        satclip_step=(satclip, *c_times), pad0=t_valid, pad0_serving=s_valid,
        pad0_satclip_step=c_valid)
    for key in ("pad0", "pad0_serving", "pad0_satclip_step"):
        RESULTS["trunk_conv"][key]["replaces"] = "nirgan_tpu/ops/pallas_trunk.py:105"

    # --- C at the head's input in serving and in training (reflect-padded
    # by 3 around the generator's input side)
    serving = (BATCH, SIDE + 6, SIDE + 6, 64)
    train = (TRAIN_BATCH, TRAIN_SIDE + 6, TRAIN_SIDE + 6, 64)
    satclip = (SATCLIP_BATCH, TRAIN_SIDE + 6, TRAIN_SIDE + 6, 64)
    e1, *s_times = check_head(g, serving)
    e2, *t_times = check_head(g, train)
    e3, *c_times = check_head(g, satclip)
    check_head_odd(g)
    RESULTS["head_conv"] = entry(
        "head_conv", "head_conv.cu", "nirgan_tpu/ops/pallas_head.py:135",
        max(e1, e2, e3), (train, *t_times), (serving, *s_times),
        satclip_step=(satclip, *c_times))
    phase_norms(g)
    phase_unet_norms(g)
    phase_convt_bwd(g)
    phase_int8_kernels(g)
    phase_int8_gathers(g)
    torch.cuda.synchronize()


def norm_shapes() -> tuple[list, list, list]:
    """The instance norm's shapes on the main path: the serving forward's
    three, and the train step's six (G at 276^2, 138^2, 69^2; D at 64^2,
    32^2, 31^2, where C = 512 is the PatchGAN's norm3) at the batch of
    ``config_px2px.yaml`` and at that of ``config_px2px_SatCLIP.yaml`` (the
    batch enters the launch plan)."""
    n, s = BATCH, SIDE
    serving = [(n, s, s, 64), (n, s // 2, s // 2, 128), (n, s // 4, s // 4, 256)]
    s = TRAIN_SIDE
    train, satclip = ([(n, s, s, 64), (n, s // 2, s // 2, 128),
                       (n, s // 4, s // 4, 256), (n, 64, 64, 128),
                       (n, 32, 32, 256), (n, 31, 31, 512)]
                      for n in (TRAIN_BATCH, SATCLIP_BATCH))
    return serving, train, satclip


def phase_norms(g: torch.Generator) -> None:
    """Kernel B at the serving forward's three IN shapes; B and B4 at the
    train step's six, at both train configs' batch sizes; ReLU fused and
    not, the skip fused and not; both again at small odd shapes on either
    side of the two regimes."""
    from nirgan_tpu_torch.ops.instance_norm import _launch, launch_plan

    dev = torch.device("cuda")
    serving_shapes, train_shapes, satclip_shapes = norm_shapes()
    worst = worst_bwd = 0.0
    fwd_all, bwd_all = [], []
    for shape in serving_shapes + train_shapes + satclip_shapes:
        train = shape not in serving_shapes
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        r = torch.randn(shape, device=dev, generator=g)
        dy = torch.randn(shape, device=dev, generator=g)
        for relu in (False, True):
            for residual in (None, r):
                worst = max(worst, check_norm(x, relu, residual))
            if train:
                worst_bwd = max(worst_bwd, check_norm_bwd(x, dy, relu))
        del r
        # time each shape with the ReLU flag the path uses there: fused in
        # the generator, not in the PatchGAN
        relu = shape[3] != 512 and shape[1] not in (64, 32)
        if shape == satclip_shapes[1]:
            # the inject route's nd0: the combination sits between the norm
            # and its ReLU, so B and B4 run there without the ReLU
            relu = False
        xb, gb = x.bfloat16(), dy.bfloat16()
        del x, dy
        fwd = (shape, *norm_times(xb, relu))
        fwd_all.append(times(*fwd))
        if train:
            bwd = (shape, *bwd_times(xb, gb, relu))
            bwd_all.append(times(*bwd))
        if shape == train_shapes[0]:
            # G's first norm, 276^2: without the ReLU too, beside the
            # library call, which has no fused ReLU
            train_bwd_top = (shape, *bwd_times(xb, gb, False))
        if shape == serving_shapes[2]:
            # the shape of 19 of the 23 calls a serving forward makes: 10
            # with the ReLU fused (nd1, each block's norm1), 9 with the skip
            serving, serving_skip = fwd, (shape, *norm_times(xb, False, skip=True))
        if shape == train_shapes[2]:
            # and of 19 of the 32 calls a step makes in each direction
            train_fwd, train_bwd = fwd, bwd
            train_skip = (shape, *norm_times(xb, False, skip=True))
            train_bwd_no_relu = (shape, *bwd_times(xb, gb, False))
        if shape == satclip_shapes[2]:
            satclip_fwd, satclip_bwd = fwd, bwd
        del xb, gb
        torch.cuda.empty_cache()

    # small shapes around the regimes' borders: channel groups of 32 (C not
    # a multiple of 64), one pixel, a C that only the streaming kernels take
    for shape in ((3, 7, 9, 96), (2, 1, 1, 64), (2, 1, 1, 8), (2, 9, 7, 24),
                  (2, 5, 5, 520)):
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        r = torch.randn(shape, device=dev, generator=g)
        dy = torch.randn(shape, device=dev, generator=g)
        log("kernels", f"instance_norm {shape}: plans forward "
            f"{plan_facts(x.bfloat16(), False)}, backward {plan_facts(x, True)}")
        for relu in (False, True):
            for residual in (None, r):
                check_norm(x, relu, residual)
            check_norm_bwd(x, dy, relu)
        # a plan that the kernels do not take is refused, not repaired
        plan = launch_plan(shape[0], shape[1] * shape[2], shape[3], 4, False)
        for bad in (plan._replace(threads=128), plan._replace(group=16),
                    plan._replace(group=64)):
            try:
                _launch(x, 1e-5, False, None, plan=bad)
            except RuntimeError as e:
                log("kernels", f"instance_norm {shape} refuses {bad}: {e}")
            else:
                raise AssertionError(f"instance_norm {shape} took {bad}")

    source, replaces = "instance_norm.cu", "nirgan_tpu/ops/pallas_kernels.py:130"
    RESULTS["instance_norm"] = entry("instance_norm", source, replaces, worst,
                                     train_fwd, serving, with_skip=train_skip,
                                     serving_with_skip=serving_skip,
                                     satclip_step=satclip_fwd)
    RESULTS["instance_norm"]["shapes"] = fwd_all
    RESULTS["instance_norm_bwd"] = entry("instance_norm_bwd", source, replaces,
                                         worst_bwd, train_bwd,
                                         no_relu=train_bwd_no_relu,
                                         no_relu_276=train_bwd_top,
                                         satclip_step=satclip_bwd)
    RESULTS["instance_norm_bwd"]["shapes"] = bwd_all
    shares = [e["bound_ms"] / e["ms"] for e in fwd_all + bwd_all]
    if max(shares) > 1.0:
        raise AssertionError(f"a kernel under its bound: {fwd_all + bwd_all}")


def check_convt(g: torch.Generator, name: str, n: int, hi: int, ci: int, co: int,
                timed: bool = True) -> tuple:
    """B5 against its plain version on z (n, hi, hi, ci) and ct (n, 2 hi,
    2 hi, co), f32 and bf16: errors relative to the largest entry.  f32
    (TF32 off): sums of 9 Co terms (dx) and of B H W terms (dW) in other
    orders: dx 1e-5, dW 1e-4.  bf16: both round dx to bf16 after f32 sums,
    and the plain dW comes back in bf16: 1e-2 each; and dx >= 40 dB.
    Returns the bf16 dx's max |err| and, if ``timed``, the arguments of
    ``times`` at this shape (bf16 kernel, plain, library call, bound)."""
    from nirgan_tpu_torch.ops.convt_bwd import (
        convt_k3s2_bwd_cuda,
        convt_k3s2_bwd_plain,
        launch_plan,
    )

    dev = torch.device("cuda")
    z = torch.randn((n, hi, hi, ci), device=dev, generator=g)
    ct = torch.randn((n, 2 * hi, 2 * hi, co), device=dev, generator=g)
    w = torch.randn((ci, co, 3, 3), device=dev, generator=g) / math.sqrt(9 * co)
    for dtype, bx, bw in ((torch.float32, 1e-5, 1e-4),
                          (torch.bfloat16, 1e-2, 1e-2)):
        zd, cd = z.to(dtype), ct.to(dtype)
        rx, rw = convt_k3s2_bwd_plain(cd, zd, w)
        gx, gw = convt_k3s2_bwd_cuda(cd, zd, w)
        ex = float((gx.float() - rx.float()).abs().max())
        ew = float((gw - rw).abs().max())
        relx = ex / float(rx.float().abs().max())
        relw = ew / float(rw.abs().max())
        db = psnr(gx, rx, float(rx.float().max() - rx.float().min()))
        log("kernels", f"convt_bwd {name} {dtype}: dx max|err| {ex:.3e} "
            f"relative {relx:.3e} (bound {bx:.0e}), {db:.2f} dB; dW max|err| {ew:.3e} "
            f"relative {relw:.3e} (bound {bw:.0e})")
        if not (relx <= bx and relw <= bw and gw.dtype == torch.float32 and db >= 40.0):
            raise AssertionError(f"convt_bwd {name} {dtype}: {relx}, {relw}, {db} dB")
        del rx, rw, gx, gw
    if not timed:
        return (ex,)
    zb, cb = z.bfloat16(), ct.bfloat16()
    del z, ct
    # the library call: both gradients from cuDNN in one call, on NCHW
    # views, the weight already in bf16
    cn, zn, wb = cb.permute(0, 3, 1, 2), zb.permute(0, 3, 1, 2), w.bfloat16()
    ms, plain_ms, lib_ms = compare_ms(
        lambda: convt_k3s2_bwd_cuda(cb, zb, w),
        lambda: convt_k3s2_bwd_plain(cb, zb, w),
        lambda: torch.ops.aten.convolution_backward(
            cn, zn, wb, None, [2, 2], [1, 1], [1, 1], True, [1, 1], 1,
            [True, True, False]), iters=10, run_ahead=True)
    paced_ms = time_ms(lambda: convt_k3s2_bwd_cuda(cb, zb, w), iters=10)
    flops = 2 * 2 * n * hi * hi * 9 * ci * co
    # ct, z and the weight in; dx in bf16 and dW in f32 out
    least = least_time(flops, nbytes(cb, zb, w) + nbytes(zb) + w.numel() * 4)
    _, slabs, slab = launch_plan(torch.bfloat16, tuple(zb.shape), tuple(cb.shape),
                                 tuple(w.shape))
    log("kernels", f"convt_bwd {name} bf16 dx+dW: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"aten.convolution_backward {lib_ms:.4f} ms, bound {least[0]:.4f} ms "
        f"({least[1]}); paced by the host {paced_ms:.4f} ms a call; dW in {slabs} "
        f"slabs of {slab} pixels")
    return ex, (f"{name}: z {tuple(zb.shape)}, ct {tuple(cb.shape)}", ms, plain_ms,
                lib_ms, least, {"dw_slabs": slabs, "slab_pixels": slab})


def phase_convt_bwd(g: torch.Generator) -> None:
    """B5 against its plain version at the train step's u1 and u0 (the
    wgmma kernels in bf16), at both train configs' batch sizes (the batch
    sets dx's tile count and dW's split-K slabs), and at a small shape that
    the wgmma kernels do not take (the WMMA kernels)."""
    nb, n8, s = TRAIN_BATCH, SATCLIP_BATCH, TRAIN_SIDE
    # u1: z (16,138,138,128), ct (16,276,276,64); u0: z (16,69,69,256), ct
    # (16,138,138,128)
    worst = 0.0
    timed = {}
    for name, n, hi, ci, co in (("u1", nb, s // 2, 128, 64),
                                ("u0", nb, s // 4, 256, 128),
                                ("satclip_u1", n8, s // 2, 128, 64),
                                ("satclip_u0", n8, s // 4, 256, 128),
                                ("small", 2, 20, 64, 32)):
        ex, *at = check_convt(g, name, n, hi, ci, co, timed=name != "small")
        worst = max(worst, ex)
        if at:
            timed[name] = at[0]
    RESULTS["convt_bwd"] = entry(
        "convt_bwd", "convt_bwd.cu", "nirgan_tpu/ops/pallas_convt_bwd.py:170",
        worst, timed.pop("u1"), **timed)


def steps_apart(got: torch.Tensor, ref: torch.Tensor, what: str) -> int:
    """The int8 outputs of a kernel against its plain version: at most one
    step apart, on at most 1e-4 of the elements (an f32 statistic summed in
    another order, or rsqrt rounded otherwise, can move a value across a
    rounding boundary).  Returns the largest difference, in steps."""
    d = (got.int() - ref.int()).abs()
    n = int((d > 0).sum())
    log("int8", f"{what}: {n} of {d.numel()} int8 outputs differ, by at most "
        f"{int(d.max())} (bound: 1 step on 1e-4 of them)")
    if int(d.max()) > 1 or n > 1e-4 * d.numel():
        raise AssertionError(f"{what}: {n} outputs differ, max {int(d.max())}")
    return int(d.max())


def abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| in f32."""
    return float((got.float() - ref.float()).abs().max())


def step_of(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values (bf16 or f32) at |v|."""
    bits = 8 if dtype == torch.bfloat16 else 24
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v.float()), e - bits).clamp(min=2.0 ** -149)


def within_ulp(got: torch.Tensor, ref: torch.Tensor, what: str,
               addend: torch.Tensor | None = None) -> float:
    """A stream (bf16 or f32) against its plain version: within one step of
    the result; for a sum ``addend + y``, also within steps of y, since y is
    a norm whose rsqrt may round one ulp apart on the two sides (up to two
    steps of y in f32; in bf16, y is rounded to one of two neighbours):
    where the two nearly cancel, a step of y is many of the sum's.  Returns
    the worst |err| / bound."""
    g, r = got.float(), ref.float()
    bound = step_of(r, ref.dtype)
    norm_steps = 1 if ref.dtype == torch.bfloat16 else 2
    if addend is not None:
        bound = bound + norm_steps * step_of(r - addend.float(), ref.dtype)
    worst = float(((g - r).abs() / bound).max())
    log("int8", f"{what}: worst |err| / bound {worst:.3f} (bound: one {ref.dtype} "
        f"step of the result" + (f" and {norm_steps} of the norm" if addend is not None
                                 else "") + ")")
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst} bf16 steps")
    return worst


def check_int8_conv(g: torch.Generator, shape: tuple, co: int,
                    timed: bool = False, border: str = "reflect",
                    stride: int = 1, ctas: int | None = None, large: bool = False) -> tuple:
    """Kernel D against its plain version on int8 x8 of ``shape`` (B, H, W,
    Cin) and a (co, Cin, 3, 3) int8 weight: the staged bf16 accumulator bit
    for bit (both round the exact int32 sum to f32, then to bf16), the f64
    moments within 1e-15 of the plain version's (both exact sums of the
    integers below 2^53), so the sums of squares within rtol 1e-5 and the
    sums within 1e-5 of their scale sqrt(n Sigma a^2) (Sigma a mixes signs),
    and a second launch bit for bit; in the gather of
    ``border`` at ``stride`` (the output (H - 1) // 2 + 1 a side at stride
    2; without a border, ``"valid"``, H - 2 and (H - 3) // 2 + 1); the
    wgmma kernel on ``ctas`` CTAs where given (longer runs of tiles), else
    on the wrapper's; with ``large``, accumulator values past 2^22 (the
    first 3 input rows of image 0 at 56, the first half of the output
    channels' weights 127: up to 9 x 128 x 56 x 127 at Cin 128, and their
    sums of squares still below 2^53).  Returns
    (x8, w8, hb, moments, worst relative moment error) and, if ``timed``,
    the kernel, plain, kernel A and mma.sync ms, the bound and the
    yardstick's ms (``int_mm_ms``)."""
    from nirgan_tpu_torch.ops.int8_trunk import (
        _launch,
        conv_moments_cuda,
        conv_moments_plain,
        out_side,
        takes_wgmma,
    )
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda

    dev = torch.device("cuda")
    ci = shape[3]
    x8 = torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (co, ci, 3, 3), device=dev, generator=g,
                       dtype=torch.int8)
    if large:
        x8[0, :3] = 56
        w8[:co // 2] = 127

    def launch():
        if ctas is None:
            return conv_moments_cuda(x8, w8, border, stride)
        return _launch(x8, w8, True, border, stride, ctas)

    hb, m = launch()
    rhb, rm = conv_moments_plain(x8, w8, border, stride)
    n = hb.shape[1] * hb.shape[2]
    sides = (out_side(shape[1], stride, border), out_side(shape[2], stride, border))
    if tuple(hb.shape) != (shape[0], *sides, co) or not torch.equal(hb, rhb):
        bad = int((hb != rhb).sum()) if hb.shape == rhb.shape else "all"
        raise AssertionError(f"int8_conv {shape}->{co} {border} s{stride}: {bad} "
                             f"staged values differ ({tuple(hb.shape)})")
    e2 = float(((m[:, 1] - rm[:, 1]).abs() / rm[:, 1].abs().clamp(min=1e-30)).max())
    e1 = float(((m[:, 0] - rm[:, 0]).abs() / (n * rm[:, 1]).sqrt().clamp(min=1e-30)).max())
    hb2, m2 = launch()
    again = torch.equal(hb2, hb) and torch.equal(m2, m)
    # the moments are the exact sums of the integers in f64, as the plain
    # version's (equal below 2^53; 1e-15 for sums past it, added in another
    # order), so that a shard's add up to the whole tile's
    e64 = float(((m - rm).abs() / rm.abs().clamp(min=1.0)).max())
    if large and not float(rhb.float().abs().max()) > 2 ** 22:
        raise AssertionError(f"int8_conv {shape}: no accumulator value past 2^22")
    if not (m.dtype == torch.float64 and e64 <= 1e-15):
        raise AssertionError(f"int8_conv {shape}->{co} {border} s{stride}: the f64 "
                             f"moments {m.dtype}, {e64}")
    packed = takes_wgmma(ci, co, n)
    log("int8", f"int8_conv {shape}->{co} {border} s{stride} "
        f"({f'wgmma on {ctas or default_ctas(hb, co)} CTAs' if packed else 'mma.sync'}): staged "
        f"accumulator equal to plain bit for bit; Sigma a^2 relative {e2:.3e}, Sigma a "
        f"{e1:.3e} of sqrt(n Sigma a^2) (bounds 1e-5); a second launch bit for bit: "
        f"{again}; the f64 sums {e64:.1e} from the plain ones (bound 1e-15)")
    if not (e1 <= 1e-5 and e2 <= 1e-5 and again):
        raise AssertionError(f"int8_conv {shape}->{co}: moments {e1}, {e2}, {again}")
    # where the wgmma kernel ran, the mma.sync kernel's gather agrees
    mma_hb, mma_m = _launch(x8, w8, False, border, stride) if packed else (hb, m)
    if not (torch.equal(mma_hb, hb) and float((mma_m - m).abs().max()
                                             / m.abs().max().clamp(min=1e-30)) <= 1e-5):
        raise AssertionError(f"int8_conv {shape} {border} s{stride}: the mma.sync "
                             "kernel disagrees")
    out = (x8, w8, hb, m, max(e1, e2))
    if not timed:
        return out
    xb = torch.randn(shape, device=dev, generator=g).bfloat16()
    wf = torch.randn((co, ci, 3, 3), device=dev, generator=g) / (3 * math.sqrt(ci))
    ms, plain_ms, a_ms, mma_ms = compare_ms(
        lambda: conv_moments_cuda(x8, w8), lambda: conv_moments_plain(x8, w8),
        lambda: trunk_conv_cuda(xb, wf), lambda: _launch(x8, w8, False), iters=10,
        run_ahead=True)
    b, h, w = shape[:3]
    ops = 2 * b * h * w * 9 * ci * co
    least = least_time(ops, nbytes(x8, w8, hb, m), PEAK_INT8_OPS)
    int_mm_ms = int_mm_yardstick(x8, w8, hb)
    log("int8", f"int8_conv {shape}->{co}: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
        f"TOPS, {least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, "
        f"{least[1]}), the mma.sync kernel {mma_ms:.4f} ms, plain (float64 conv) "
        f"{plain_ms:.4f} ms, kernel A (bf16) at the same shape {a_ms:.4f} ms; "
        f"torch._int_mm on the same GEMM (M {b * h * w}, K {9 * ci}, N {co}; its "
        f"im2col made beforehand) {int_mm_ms:.4f} ms")
    return out + (ms, plain_ms, a_ms, mma_ms, least, int_mm_ms)


def default_ctas(hb: torch.Tensor, co: int) -> int:
    """The wgmma kernel's CTAs that kernel D's wrapper takes for output hb."""
    from nirgan_tpu_torch.ops.int8_trunk import s8_ctas, sm_count

    return s8_ctas(hb.shape[0] * hb.shape[1] * hb.shape[2], co, sm_count(hb.device.index))


def int_mm_yardstick(x8: torch.Tensor, w8: torch.Tensor, hb: torch.Tensor) -> float:
    """cuBLASLt's s8 GEMM (``torch._int_mm``) on kernel D's GEMM at stride 1
    with the reflect border: M output pixels, K = 9 Cin, N = Cout, the
    im2col made before the clock starts.  A yardstick of the card's s8
    rate for the same operations, not a call that computes D's function
    (no border, no moments): D's ``library_ms`` stays null.  Checked to give
    D's accumulator (rounded, D's staged output) before it is timed."""
    b, h, w, ci = x8.shape
    co = w8.shape[0]
    # the reflect border's indices: -1 -> 1, n -> n - 2
    rows = torch.tensor([1, *range(h), h - 2], device=x8.device)
    cols = torch.tensor([1, *range(w), w - 2], device=x8.device)
    xp = x8.index_select(1, rows).index_select(2, cols)
    a = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                  dim=3).reshape(b * h * w, 9 * ci)
    # (K, N) column-major, cuBLASLt's fast layout (row-major took 5.7x as long)
    wm = w8.permute(2, 3, 1, 0).reshape(9 * ci, co).t().contiguous().t()
    acc = torch._int_mm(a, wm)
    if not torch.equal(acc.float().bfloat16().reshape(hb.shape), hb):
        raise AssertionError("torch._int_mm's GEMM is not D's")
    ms = time_ms(lambda: torch._int_mm(a, wm), iters=10, run_ahead=True)
    del a, acc
    return ms


def check_int8_norm(g: torch.Generator, hb: torch.Tensor, m: torch.Tensor,
                    timed: bool = False) -> tuple[dict, dict]:
    """Kernel E against its plain version in its four modes on kernel D's
    staged accumulator ``hb`` and moments ``m``, with a bf16 and an f32
    stream: mode 0 bit for bit (``bit_for_bit``: a true f32 division on
    either side, no statistic), modes 1-3's int8 outputs at most one step
    apart on at most 1e-4 of them, the stream within one step of its type and one of the norm
    (``within_ulp``; mode 3's bf16 stream within one bf16 step, its f32
    stream within one f32 step and two of the norm, as mode 2's), a second
    launch bit for bit, and on other plans bit for bit (``check_norm_plans``).
    Returns the largest |kernel - plain| of each mode over its outputs (int8
    steps and stream values) and, with ``timed``, the times of each mode,
    its plain version and the bound, by mode."""
    from nirgan_tpu_torch.ops.int8_trunk import norm_quant_cuda, norm_quant_plain

    dev = torch.device("cuda")
    shape = tuple(hb.shape)
    eps, s = e_constants(g, m)
    x = torch.randn(shape, device=dev, generator=g) * 2.0
    out, err = {}, dict.fromkeys(range(4), 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        xs = x.to(dtype)
        tag = f"int8_norm {shape} stream {dtype}"
        q0 = norm_quant_cuda(0, xs, s)
        e0 = bit_for_bit(q0, norm_quant_plain(0, xs, s), f"{tag} mode 0")
        q1 = norm_quant_cuda(1, hb, s, m, eps)
        e1 = steps_apart(q1, norm_quant_plain(1, hb, s, m, eps), f"{tag} mode 1")
        o2, q2 = norm_quant_cuda(2, hb, s, m, eps, xs)
        r2, rq2 = norm_quant_plain(2, hb, s, m, eps, xs)
        e2 = max(steps_apart(q2, rq2, f"{tag} mode 2"), abs_err(o2, r2))
        within_ulp(o2, r2, f"{tag} mode 2 stream", addend=xs)
        o3, q3 = norm_quant_cuda(3, hb, s, m, eps, dtype=dtype)
        r3, rq3 = norm_quant_plain(3, hb, s, m, eps, dtype=dtype)
        within_ulp(o3, r3, f"{tag} mode 3 stream",
                   addend=None if dtype == torch.bfloat16 else torch.zeros_like(r3))
        e3 = max(steps_apart(q3, rq3, f"{tag} mode 3"), abs_err(o3, r3))
        for mode, e in enumerate((e0, e1, e2, e3)):
            err[mode] = max(err[mode], e)
        last, none = norm_quant_cuda(2, hb, None, m, eps, xs)
        if none is not None or not torch.equal(last, o2):
            raise AssertionError(f"{tag} mode 2 without a next block")
        again = norm_quant_cuda(2, hb, s, m, eps, xs)
        again3 = norm_quant_cuda(3, hb, s, m, eps, dtype=dtype)
        if not (torch.equal(again[0], o2) and torch.equal(again[1], q2)
                and torch.equal(again3[0], o3) and torch.equal(again3[1], q3)
                and torch.equal(norm_quant_cuda(1, hb, s, m, eps), q1)):
            raise AssertionError(f"{tag}: a second launch differs")
        check_norm_plans(tag, ((0, xs, s), q0), ((1, hb, s, m, eps), q1),
                         ((2, hb, s, m, eps, xs), (o2, q2)),
                         ((3, hb, s, m, eps, None, dtype), (o3, q3)))
    if not timed:
        return err, out
    xb = x.bfloat16()
    modes = {0: (lambda: norm_quant_cuda(0, xb, s), lambda: norm_quant_plain(0, xb, s),
                 nbytes(xb) + xb.numel()),
             1: (lambda: norm_quant_cuda(1, hb, s, m, eps),
                 lambda: norm_quant_plain(1, hb, s, m, eps),
                 nbytes(hb, m) + hb.numel()),
             2: (lambda: norm_quant_cuda(2, hb, s, m, eps, xb),
                 lambda: norm_quant_plain(2, hb, s, m, eps, xb),
                 nbytes(hb, m, xb, xb) + hb.numel()),
             3: (lambda: norm_quant_cuda(3, hb, s, m, eps, dtype=torch.bfloat16),
                 lambda: norm_quant_plain(3, hb, s, m, eps, dtype=torch.bfloat16),
                 nbytes(hb, m, xb) + hb.numel())}
    for mode, (kernel, plain, moved) in modes.items():
        ms, plain_ms = compare_ms(kernel, plain, iters=20, run_ahead=True)
        least = least_time(0, moved)
        log("int8", f"int8_norm {shape} mode {mode}: kernel {ms:.4f} ms "
            f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}), "
            f"plain {plain_ms:.4f} ms")
        out[mode] = (shape, ms, plain_ms, None, least)
    return err, out


def bit_for_bit(got: torch.Tensor, ref: torch.Tensor, what: str) -> int:
    """The int8 outputs of a kernel equal to its plain version's bit for
    bit; returns 0, the largest difference in steps."""
    n = int((got != ref).sum())
    log("int8", f"{what}: {n} of {got.numel()} int8 outputs differ (bound: none)")
    if n:
        d = (got.int() - ref.int()).abs()
        raise AssertionError(f"{what}: {n} outputs differ, max {int(d.max())} steps")
    return 0


# the 17 values of the last row of ``e_near_halves``, in every channel: NaN,
# the infinities, zeros, subnormals, values past the clip and far out
E_SPECIALS = (float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40, -1e-40, 3e38,
              -3e38, 1e-30, -1e-30, 1.0, -1.0, 0.015625, -0.015625, 127.49, -127.51)


def e_near_halves(g: torch.Generator, dtype: torch.dtype, odd: bool = False) -> tuple:
    """Kernel E's mode 0 inputs where the product by a rounded reciprocal
    can round otherwise than the true division: (x (1, 257, 17, 256) in
    ``dtype``, s (256,) f32).  Row i < 256 of channel c holds the
    half-integer i - 127.5 times c's base scale, moved by -8 to 8 steps of
    ``dtype`` along the row; row 256 holds ``E_SPECIALS``.  The scales are
    calibrated, (0.5-1.5) 3 / 127, but channels 0-7 powers of two (the
    quotients exactly on a half-integer: ties), 8-15 negative, and 64-255
    v / h moved by 1-4 steps of 2^-24 either way, for a half-integer h of
    the channel's own and v a bf16 value near h times a calibrated scale
    (that element then divides to within a few f32 steps of h, where
    bf16's own steps reach a half-integer that closely only by chance).  With
    ``odd``, channel 16's scale is 0 and 17's 2^-70, its values built on
    2^-70: scales outside [2^-64, 2^64], so that every block divides."""
    c = 256
    s = (torch.rand(c, device="cuda", generator=g) + 0.5) * 3.0 / 127
    s[:8] = 2.0 ** -torch.arange(3, 11, device="cuda", dtype=torch.float32)
    s[8:16] = -s[8:16]
    halves = torch.arange(-127.5, 128.0, 1.0, device="cuda", dtype=torch.float64)
    h = halves[torch.randint(0, 256, (c - 64,), device="cuda", generator=g)]
    j = torch.randint(1, 5, (c - 64,), device="cuda", generator=g).double()
    j = j * (torch.randint(0, 2, (c - 64,), device="cuda", generator=g) * 2 - 1)
    v = (h * s[64:].double()).bfloat16().double()
    s[64:] = (v / h * (1 + j * 2.0 ** -24)).float()
    base = s.clone()
    if odd:
        s[16], s[17] = 0.0, 2.0 ** -70
        base[17] = 2.0 ** -70
    v0 = (halves[:, None] * base.double()[None, :]).to(dtype)
    itype = torch.int16 if dtype == torch.bfloat16 else torch.int32
    steps = torch.arange(-8, 9, device="cuda", dtype=itype)
    x = (v0.view(itype)[:, None, :] + steps[None, :, None]).view(dtype)
    specials = torch.tensor(E_SPECIALS, device="cuda").to(dtype)
    x = torch.cat([x, specials[None, :, None].expand(1, len(E_SPECIALS), c)])
    return x[None].contiguous(), s


def check_int8_norm_exact(g: torch.Generator) -> None:
    """Kernel E's mode 0 bit for bit with ``quantize_plain`` (an IEEE f32
    division, rounded half to even) on ``e_near_halves``' inputs, bf16 and
    f32: with calibrated scales, where the guard must settle every element
    that the bare product by the reciprocal rounds otherwise (some must:
    the inputs are checked to reach the guard), and with a scale of 0 and
    one of 2^-70, where every block divides."""
    from nirgan_tpu_torch.ops.int8_trunk import norm_quant_cuda, q8, quantize_plain

    for dtype in (torch.bfloat16, torch.float32):
        for odd in (False, True):
            x, s = e_near_halves(g, dtype, odd)
            tag = f"int8_norm mode 0 near half-integers {dtype} {'odd' if odd else 'nice'} scales"
            want = quantize_plain(x, s)
            bit_for_bit(norm_quant_cuda(0, x, s), want, tag)
            if not odd:
                bare = q8(x.float() * torch.reciprocal(s))
                n = int((bare != want).sum())
                log("int8", f"{tag}: the bare product differs on {n} of {x.numel()}")
                if not n:
                    raise AssertionError(f"{tag}: the inputs do not reach the guard")


def check_norm_plans(tag: str, *calls) -> None:
    """Kernel E's outputs on other plans than its own equal to its own bit
    for bit: each (arguments of ``norm_quant_cuda``, its outputs) again on
    one block an image, on two, on a pixel a block (at most 4096 blocks)
    and on a tenth of the plan's blocks."""
    from nirgan_tpu_torch.ops import int8_trunk

    for args, want in calls:
        b, h, w, c = args[1].shape
        mode = args[0]
        code = e_code(args)
        plan = int8_trunk.norm_blocks(b, h * w, c, int8_trunk.norm_slots(0, mode, code, c),
                                      int8_trunk.norm_pass(mode, code))
        for blocks in sorted({1, min(2, h * w), min(h * w, 4096), max(1, plan // 10)}):
            got = int8_trunk._launch_norm(*args, blocks=blocks)
            pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
            if not all(torch.equal(a, b) for a, b in pairs if a is not None or b is not None):
                raise AssertionError(f"{tag} mode {mode} on {blocks} blocks an image "
                                     f"(the plan's {plan}) differs")


def e_code(args: tuple) -> int:
    """The dtype code (0 f32, 1 bf16) of E's instance for the arguments of
    ``norm_quant_cuda``: the stream's (mode 0 its source, mode 2 x, mode 3
    the dtype), the accumulator's bf16 in mode 1."""
    mode = args[0]
    dtype = (args[1].dtype if mode in (0, 1) else args[5].dtype if mode == 2 else args[6])
    return 1 if dtype == torch.bfloat16 else 0


def norm_inputs(g: torch.Generator, shape: tuple) -> tuple:
    """A staged bf16 accumulator of ``shape`` at an int8 conv's scale and
    its exact f64 moments (B, 2, C), without kernel D: for E at the widths
    no trunk has."""
    hb = (torch.randn(shape, device="cuda", generator=g) * 3000
          + torch.rand(shape[-1], device="cuda", generator=g) * 500).bfloat16()
    a = hb.double()
    return hb, torch.stack([a.sum(dim=(1, 2)), a.square().sum(dim=(1, 2))], 1).contiguous()


# kernel E's odd shapes (B, H, W, C) beyond those D gives it: a batch of 1
# whose 63 pixels are no multiple of a pass (UNROLL x rows = 32 at C = 256),
# C = 8 (one group, 256 rows) and C = 2048 (256 groups, one row), a pixel
# count below one pass, and 5 images of 221 pixels at C = 64
NORM_ODD_SHAPES = ((1, 7, 9, 256), (3, 5, 7, 8), (2, 9, 11, 2048), (2, 3, 3, 128),
                   (5, 13, 17, 64))


def phase_int8_kernels(g: torch.Generator) -> None:
    """Kernels D and E against their plain versions at the serving trunk's
    shape (batch 4 of 512^2 tiles padded to 532^2: 133^2, 256 channels) and
    at small odd shapes (a Cout that is no multiple of 128, an image whose
    pixels end inside a tile, a column of width 3; E also at
    ``NORM_ODD_SHAPES``), D timed beside kernel A at its shape, E in each
    mode."""
    serving = (BATCH, SIDE // 4, SIDE // 4, 256)
    x8, w8, hb, m, err, *d_times = check_int8_conv(g, serving, 256, timed=True)
    e_err, e_times = check_int8_norm(g, hb, m, timed=True)
    check_int8_norm_exact(g)
    del x8, w8, hb, m
    # mma.sync: Cout no multiple of 128, an image ending inside a tile, a
    # width of 3; wgmma: tiles that straddle two images (N 256 and 128)
    for shape, co in (((2, 9, 11, 32), 40), ((1, 130, 3, 64), 256),
                      ((3, 17, 13, 96), 136), ((3, 12, 11, 256), 256),
                      ((3, 20, 30, 128), 128)):
        _, _, hb, m, e, = check_int8_conv(g, shape, co)
        err = max(err, e)
        small = check_int8_norm(g, hb, m)[0]
        e_err = {mode: max(e, small[mode]) for mode, e in e_err.items()}
    for shape in NORM_ODD_SHAPES:
        small = check_int8_norm(g, *norm_inputs(g, shape))[0]
        e_err = {mode: max(e, small[mode]) for mode, e in e_err.items()}
    ms, plain_ms, a_ms, mma_ms, least, int_mm_ms = d_times
    RESULTS["int8_conv"] = entry(
        "int8_conv", "int8_conv.cu", "nirgan_tpu/ops/int8_trunk.py:103", err,
        (serving, ms, plain_ms, None, least,
         dict(kernel="s8 wgmma (igemm_wgmma.cu: igemm_s8_kernel)",
              kernel_a_ms=a_ms, mma_sync_ms=mma_ms, share=least[0] / ms,
              int_mm_ms=int_mm_ms,
              note="no PyTorch call convolves int8 on a card: library_ms null; "
                   "kernel_a_ms is the bf16 trunk conv at the same shape, "
                   "mma_sync_ms the mma.sync kernel that other widths take, "
                   "int_mm_ms torch._int_mm (cuBLASLt s8) on the same GEMM with "
                   "its im2col made beforehand: a yardstick of the s8 rate, "
                   "not D's function")))
    # max_abs_err: of modes 0 to 2 (mode 3 is an entry of its own), int8
    # steps or stream values, whichever is larger
    RESULTS["int8_norm"] = entry(
        "int8_norm", "int8_norm.cu", "nirgan_tpu/ops/int8_trunk.py:94",
        max(e_err[0], e_err[1], e_err[2]), e_times[2], mode0=e_times[0],
        mode1=e_times[1], mode3=e_times[3])
    RESULTS["int8_norm"]["mode3"]["max_abs_err"] = e_err[3]
    torch.cuda.synchronize()


# kernel D's other gathers against their plain versions: (border, stride,
# shape, Cout).  wgmma: tiles that straddle two images (N 256 and 128), the
# odd and even sides at stride 2, a last tile cut short; mma.sync: a Cout
# that is no multiple of 128, images smaller than a tile, a width of 3
GATHER_SHAPES = (
    ("replicate", 1, (3, 12, 11, 256), 256), ("zero", 1, (3, 12, 11, 256), 256),
    ("replicate", 1, (3, 20, 30, 128), 128), ("zero", 1, (3, 20, 30, 128), 128),
    ("replicate", 1, (2, 9, 11, 32), 40), ("zero", 1, (1, 130, 3, 64), 256),
    ("zero", 2, (3, 27, 25, 128), 256), ("zero", 2, (3, 28, 26, 128), 256),
    ("zero", 2, (2, 33, 35, 128), 128), ("zero", 2, (2, 34, 36, 128), 128),
    ("zero", 2, (2, 9, 13, 64), 40), ("zero", 2, (1, 10, 6, 32), 16),
)

# the cases the wgmma kernel's walk adds, in every gather: 3 images of 15 x
# 13 output pixels (Cout 256: 585 pixels, 10 grains of 64; tiles that
# straddle two images; 585 no multiple of 128), and the N = 128 form at 5
# images of 17 x 19 (7 tiles of 256); each on the wrapper's CTAs (5 and 7:
# a tile each), on 3 (runs of 3 or 4 grains: a CTA ending on a half tile)
# and on 1 (one run walking them all)
WALK_SHAPES = (
    ("reflect", 1, (3, 15, 13, 128), 256), ("replicate", 1, (3, 15, 13, 128), 256),
    ("zero", 1, (3, 15, 13, 128), 256), ("zero", 2, (3, 29, 25, 128), 256),
    ("valid", 1, (3, 17, 15, 128), 256), ("valid", 2, (3, 31, 27, 128), 256),
    ("reflect", 1, (5, 17, 19, 128), 128),
)


def check_walk_cases(g: torch.Generator) -> float:
    """Kernel D's wgmma kernel at ``WALK_SHAPES`` on the wrapper's CTAs, on
    3 and on 1, and with large values, against its plain version
    (``check_int8_conv``).  Returns the worst relative moment error."""
    err = 0.0
    for border, stride, shape, co in WALK_SHAPES:
        for ctas in (None, 3, 1):
            err = max(err, check_int8_conv(g, shape, co, border=border, stride=stride,
                                           ctas=ctas)[-1])
        err = max(err, check_int8_conv(g, shape, co, border=border, stride=stride,
                                       large=True)[-1])
    return err


def phase_int8_gathers(g: torch.Generator) -> None:
    """Kernel D in the gathers the JAX int8 code also uses, each against its
    plain version (the staged accumulator bit for bit, exact in s32; the
    moments as ``check_int8_conv`` holds them): the replicate and zero
    borders at stride 1 (the padded int8 trunks) and the zero border at
    stride 2 (stage 2's d1 conv) at ``GATHER_SHAPES`` and at the serving
    shapes, timed there: the padded trunks' (4, 133^2, 256) -> 256 beside
    the reflect gather, the plain version and kernel A's ``pad=0`` on the
    padded bf16 input (the float route of those trunks); d1's (4, 266^2,
    128) -> 256 at stride 2 beside the plain version and the float route of
    that layer (cuDNN's strided conv, then kernel B's norm with the ReLU),
    and the whole ``int8_d1_forward`` (E, D, E) beside it."""
    from nirgan_tpu_torch.ops.conv import conv2d
    from nirgan_tpu_torch.ops.instance_norm import instance_norm_cuda
    from nirgan_tpu_torch.ops.int8_trunk import (
        conv_moments_cuda,
        conv_moments_plain,
        int8_d1_forward,
        quant_folded,
    )
    from nirgan_tpu_torch.ops.pad import replicate_pad2d, zero_pad2d
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda

    dev = torch.device("cuda")
    err = check_walk_cases(g)
    for border, stride, shape, co in GATHER_SHAPES:
        err = max(err, check_int8_conv(g, shape, co, border=border, stride=stride)[-1])
    entries = {}
    trunk = (BATCH, SIDE // 4, SIDE // 4, 256)
    for border, pad in (("replicate", replicate_pad2d), ("zero", zero_pad2d)):
        x8, w8, hb, m, e = check_int8_conv(g, trunk, 256, border=border)
        err = max(err, e)
        xb = torch.randn(trunk, device=dev, generator=g).bfloat16()
        wf = torch.randn((256, 256, 3, 3), device=dev, generator=g) / 48
        xp = pad(xb, 1)
        ms, reflect_ms, plain_ms, a_ms = compare_ms(
            lambda: conv_moments_cuda(x8, w8, border),
            lambda: conv_moments_cuda(x8, w8),
            lambda: conv_moments_plain(x8, w8, border),
            lambda: trunk_conv_cuda(xp, wf, pad=0), iters=10, run_ahead=True)
        ops = 2 * math.prod(trunk[:3]) * 9 * 256 * 256
        least = least_time(ops, nbytes(x8, w8, hb, m), PEAK_INT8_OPS)
        log("int8", f"int8_conv {trunk}->256 {border}: kernel {ms:.4f} ms "
            f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}), "
            f"the reflect gather {reflect_ms:.4f} ms, plain {plain_ms:.4f} ms, kernel A "
            f"pad=0 (bf16, the float route) {a_ms:.4f} ms")
        entries[border] = (trunk, ms, plain_ms, a_ms, least,
                           dict(reflect_ms=reflect_ms, share=least[0] / ms))
        del x8, w8, hb, m, xb, xp
    d1 = (BATCH, SIDE // 2, SIDE // 2, 128)
    x8, w8, hb, m, e = check_int8_conv(g, d1, 256, border="zero", stride=2)
    err = max(err, e)
    xb = torch.relu(torch.randn(d1, device=dev, generator=g)).bfloat16()
    wf = (torch.randn((256, 128, 3, 3), device=dev, generator=g) / 34).bfloat16()
    bias = torch.zeros(256, device=dev, dtype=torch.bfloat16)
    s_in = torch.full((128,), 3.0 / 127, device=dev)
    wq, eps = quant_folded(wf.float(), s_in)
    qd1 = {"w": wq, "eps": eps, "s_in": s_in}
    s_next = torch.full((256,), 2.5 / 127, device=dev)

    def float_route():
        return instance_norm_cuda(conv2d(xb, wf, bias, 2, 1), relu=True)

    ms, plain_ms, bf16_ms, fwd_ms = compare_ms(
        lambda: conv_moments_cuda(x8, w8, "zero", 2),
        lambda: conv_moments_plain(x8, w8, "zero", 2), float_route,
        lambda: int8_d1_forward(xb, qd1, s_next), iters=10, run_ahead=True)
    n_out = hb.shape[1] * hb.shape[2]
    ops = 2 * BATCH * n_out * 9 * 128 * 256
    least = least_time(ops, nbytes(x8, w8, hb, m), PEAK_INT8_OPS)
    log("int8", f"int8_conv {d1}->256 zero stride 2 (stage 2's d1): kernel {ms:.4f} ms "
        f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}), plain "
        f"{plain_ms:.4f} ms; int8_d1_forward (E, D, E) {fwd_ms:.4f} ms against the "
        f"float route (cuDNN's strided conv + kernel B) {bf16_ms:.4f} ms")
    entries["stride2"] = (d1, ms, plain_ms, bf16_ms, least,
                          dict(int8_d1_forward_ms=fwd_ms, share=least[0] / ms))
    note = ("library_ms: the float route of the same layer (kernel A pad=0 on the "
            "padded bf16 input; for stride 2 cuDNN's bf16 strided conv followed by "
            "kernel B's norm and ReLU): no PyTorch call convolves int8 on a card")
    RESULTS["int8_conv_gathers"] = {
        "max_abs_err": err, "note": note,
        **{k: {**times(*v), "shape": str(v[0])} for k, v in entries.items()}}
    torch.cuda.synchronize()


def int8_forward_launches(stage2: bool) -> dict:
    """D's and E's calls in one int8 forward of the 9-block generator: with
    stage 2 one D more (d1), and E's quantisation of the trunk's input moves
    to d1's input while d1's end (mode 3) writes the trunk's."""
    return ({"int8_conv": 19, "int8_norm": 20} if stage2 else INT8_FORWARD)


def phase_int8_serving(satclip: bool = False, stage2: bool = False,
                       padding: str = "reflect") -> dict:
    """The int8 serving forward of the full-width generator (the plain one,
    or the inject one of ``config_px2px_SatCLIP.yaml``; with ``stage2`` d1
    in int8 too; with the trunk's ``padding`` replicate or zero), batch 4 at
    532^2, the trunk calibrated on that batch: D and E launches a forward; against
    the plain route (the same pack through D and E's plain versions) >= 40
    dB, the JAX package's bound for the int8 trunk summed in another order
    (``tests/test_int8_trunk.py::test_int8_under_spatial_sharding``: a
    moment rounded otherwise moves an int8 value by a step, and that passes
    on through the blocks); against the bf16 float forward within 1 dB of
    what the method gives on the plain versions throughout (the kernels add
    nothing to the quantisation's own error) and >= 33 dB, far above what a
    wrong scale or weight would give; a second forward bit for bit; and its
    time beside the float forward's."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G, define_G_inject
    from nirgan_tpu_torch.ops.int8_trunk import calibrate_trunk, quantize_trunk

    dev = torch.device("cuda")
    tag = ("int8 serving" + (", inject" if satclip else "")
           + (", stage 2" if stage2 else "")
           + (f", {padding} trunk" if padding != "reflect" else ""))
    seeded = torch.Generator().manual_seed(SEED)
    if satclip:
        G = define_G_inject(load_config(SATCLIP_CONFIG), compute_dtype=torch.bfloat16,
                            generator=seeded).to(dev).eval()
        embeds = (torch.randn((BATCH, 256), generator=seeded).to(dev),)
    else:
        G = define_G(3, 1, 64, "resnet_9blocks", "instance",
                     compute_dtype=torch.bfloat16, generator=seeded).to(dev).eval()
        embeds = ()
    G.padding_type = padding
    for i in range(G.n_blocks):
        getattr(G, f"r{i}").padding_type = padding
    x = (torch.rand((BATCH, SIDE, SIDE, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
    with torch.inference_mode():
        calib = calibrate_trunk(G, x, *embeds, stage2=stage2)
    with torch.no_grad():
        pack = quantize_trunk(G.state_dict(), G.n_blocks, calib)
    want = int8_forward_launches(stage2)
    with torch.inference_mode():
        reset_counts()
        y8 = G(x, *embeds, trunk_q=pack)
        torch.cuda.synchronize()
        per_forward, floats, routes = int8_counts(), counts(), int8_by_route()
        no_library(tag)
        trunk = 2 * G.n_blocks
        want_routes = {"int8_conv": {f"{padding} s1": trunk, **({"zero s2": 1} if stage2
                                                               else {})},
                       "int8_norm": {"mode 0": 1, "mode 1": G.n_blocks,
                                     "mode 2": G.n_blocks, **({"mode 3": 1} if stage2
                                                              else {})}}
        log(tag, f"launches per forward {per_forward} (want {want}), by gather and "
            f"mode {routes}, float kernels {floats}")
        if per_forward != want or routes != want_routes or floats["trunk_conv"] != 0:
            raise AssertionError(f"{tag}: launches {per_forward}, {routes}, {floats}")
        INT8_ROUTES[tag] = routes
        if tuple(y8.shape) != (BATCH, SIDE, SIDE, 1) or not torch.isfinite(y8).all():
            raise AssertionError(f"{tag}: bad output {tuple(y8.shape)}")
        same = torch.equal(G(x, *embeds, trunk_q=pack), y8)
        with int8_plain_route():
            y_plain = G(x, *embeds, trunk_q=pack)
        y_float = G(x, *embeds)
        db_plain, db_float = psnr(y8, y_plain, 2.0), psnr(y8, y_float, 2.0)
        # the same comparisons wholly on the plain versions, to tell the
        # method's error from the kernels'
        with plain_route():
            all_plain = psnr(G(x, *embeds, trunk_q=pack), G(x, *embeds), 2.0)
            float_plain = psnr(G(x, *embeds), y_float, 2.0)
        log(tag, f"int8 forward vs D and E's plain versions {db_plain:.2f} dB (bound "
            f"40), vs the bf16 float forward {db_float:.2f} dB (bound: >= 33 and "
            f"within 1 dB of the plain versions' {all_plain:.2f}); a second forward "
            f"bit for bit: {same}; the float forward, kernels vs plain "
            f"{float_plain:.2f} dB")
        if not (db_plain >= 40.0 and db_float >= max(33.0, all_plain - 1.0) and same):
            raise AssertionError(f"{tag}: {db_plain}, {db_float} ({all_plain}), {same}")
        if not stage2:
            ms8, msf = compare_ms(lambda: G(x, *embeds, trunk_q=pack),
                                  lambda: G(x, *embeds), iters=10)
            log(tag, f"forward of {BATCH} x {SIDE}^2: int8 trunk {ms8:.3f} ms, bf16 "
                f"{msf:.3f} ms")
            return per_forward
        # stage 2 against the trunk-only pack and the float forward, in turns
        trunk_only = {k: v for k, v in pack.items() if k != "d1"}
        db_trunk = psnr(G(x, *embeds, trunk_q=trunk_only), y_float, 2.0)
        ms2, ms8, msf = compare_ms(lambda: G(x, *embeds, trunk_q=pack),
                                   lambda: G(x, *embeds, trunk_q=trunk_only),
                                   lambda: G(x, *embeds), iters=10)
        log(tag, f"forward of {BATCH} x {SIDE}^2: stage 2 {ms2:.3f} ms "
            f"({db_float:.2f} dB from bf16), trunk only {ms8:.3f} ms ({db_trunk:.2f} "
            f"dB), bf16 {msf:.3f} ms")
        STAGE2.update(ms=ms2, trunk_only_ms=ms8, bf16_ms=msf, db=db_float,
                      trunk_only_db=db_trunk)
    return per_forward


def phase_generator(satclip: bool = False) -> dict:
    """The full-width generator, plain or (``satclip``) the inject variant
    of ``config_px2px_SatCLIP.yaml`` with seeded embeddings.  Returns the
    launches of one forward."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G, define_G_inject
    from nirgan_tpu_torch.tasks import Px2PxTask

    dev = torch.device("cuda")
    tag = "generator, inject" if satclip else "generator"
    config = SATCLIP_CONFIG if satclip else CONFIG
    seeded = torch.Generator().manual_seed(SEED)
    if satclip:
        G = define_G_inject(load_config(config), compute_dtype=torch.bfloat16,
                            generator=seeded).to(dev).eval()
        # embeddings of the tower's size; the scale at 0.5, not the config's
        # 0.01, so that a fault in the plane would show in the output
        embeds = (torch.randn((BATCH, 256), generator=seeded).to(dev),)
        with torch.no_grad():
            G.scale_param.fill_(0.5)
    else:
        G = define_G(3, 1, 64, "resnet_9blocks", "instance",
                     compute_dtype=torch.bfloat16, generator=seeded).to(dev).eval()
        embeds = ()
    x = torch.rand((BATCH, SIDE, SIDE, 3), generator=torch.Generator().manual_seed(1))
    x = (x * 0.3).to(dev)
    with torch.inference_mode():
        reset_counts()
        y = G(x, *embeds)
        torch.cuda.synchronize()
        per_forward = counts()
        no_library(tag)
        with plain_route():
            y_plain = G(x, *embeds)
        torch.cuda.synchronize()
        want = EVAL_LAUNCHES
        log(tag, f"launches per forward {per_forward} (want {want})")
        if per_forward != want:
            raise AssertionError(f"launches {per_forward} != {want}")
        if tuple(y.shape) != (BATCH, SIDE, SIDE, 1) or not torch.isfinite(y).all():
            raise AssertionError(f"bad generator output {tuple(y.shape)}")
        # tanh outputs span 2; the JAX package measured its own bf16-vs-f32
        # floor at 43 dB, so kernels vs plain in bf16 must reach 40 dB
        db = psnr(y, y_plain, 2.0)
        log(tag, f"bf16 kernel path vs plain path: PSNR {db:.2f} dB "
            f"(bound 40), max|err| {float((y.float() - y_plain.float()).abs().max()):.3e}")
        if not db >= 40.0:
            raise AssertionError(f"generator PSNR {db} < 40")
        if satclip:
            moved = float((G(x, -embeds[0]).float() - y.float()).abs().max())
            log(tag, f"the embeddings reach the output: max|diff| {moved:.3e} "
                "with their sign turned")
            if not moved > 1e-3:
                raise AssertionError(f"the embeddings do not reach the output: {moved}")

        def plain_forward():
            with plain_route():
                return G(x, *embeds)

        ms, plain_ms = compare_ms(lambda: G(x, *embeds), plain_forward, iters=10)
        log(tag, f"bf16 forward of {BATCH} x {SIDE}^2: kernels {ms:.3f} ms "
            f"({BATCH / ms * 1e3:.2f} tiles/s), plain {plain_ms:.3f} ms "
            f"({BATCH / plain_ms * 1e3:.2f} tiles/s)")

    # predict_step in f32 on the card (kernels, TF32 off) against the same
    # seeded task on the CPU (plain versions)
    cfg = load_config(config)
    cfg.tpu.compute_dtype = "float32"
    rng = np.random.default_rng(2)
    rgb = rng.random((2, 3, 64, 64), dtype=np.float32) * 0.3
    coords = ((rng.random((2, 2)) * [360, 180] - [180, 90]).astype(np.float32),) \
        if satclip else ()
    reset_counts()
    got = Px2PxTask(cfg, device="cuda", seed=SEED).predict_step(rgb, *coords)
    on_card = counts()
    ref = Px2PxTask(cfg, device="cpu", seed=SEED).predict_step(rgb, *coords)
    err = float(np.abs(got - ref).max())
    # f32 on both sides; nine IN-normalised blocks amplify summation-order
    # differences, so abs 1e-3 on tanh outputs
    log(tag, f"predict_step f32 (2, 3, 64, 64){' with coords' if satclip else ''}, "
        f"card vs CPU: max|err| {err:.3e} (bound 1e-03), launches {on_card}")
    if not (got.shape == (2, 1, 64, 64) and err <= 1e-3):
        raise AssertionError(f"predict_step card vs CPU: {got.shape}, {err}")
    if min(on_card[k] for k in SERVING_KERNELS) == 0:
        raise AssertionError(f"predict_step on the card skipped a kernel: {on_card}")
    return per_forward


def write_tiles(root: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded uint16 DN tiles with lon/lat coordinates in the LR/HR ``.npz``
    layout the CLI reads; returns the HR and LR stacks and the coordinates."""
    rng = np.random.default_rng(SEED)
    hr = rng.integers(0, 3000, (n, 3, TILE, TILE), dtype=np.uint16)
    lr = rng.integers(0, 3000, (n, 4, LR_TILE, LR_TILE), dtype=np.uint16)
    coords = (rng.random((n, 2)) * [360, 180] - [180, 90]).astype(np.float32)
    for sub in ("HR", "LR"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        np.savez(os.path.join(root, "HR", f"tile_{i:03d}.npz"), img=hr[i],
                 coords=coords[i])
        np.savez(os.path.join(root, "LR", f"tile_{i:03d}.npz"), img=lr[i],
                 coords=coords[i])
    return hr, lr, coords


def phase_serving(tmp: str, config: str = CONFIG, tag: str = "serving",
                  quant: str | None = None) -> dict:
    """The serving CLI on ``config`` (``tag`` names the run's lines and
    output folders; ``quant`` is passed as ``--quant``).  Returns the run's
    launches, the int8 kernels' beside the float ones."""
    from nirgan_tpu_torch import create_synthetic_dataset as cli
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference import serve_batch
    from nirgan_tpu_torch.tasks import Px2PxTask

    data = os.path.join(tmp, "data")
    hr_np, lr_np, coords = write_tiles(data, SERVE_TILES)

    def argv(out: str) -> list:
        return ["--config", config, "--data", data, "--out",
                os.path.join(tmp, f"{tag}_{out}"), "--ckpt",
                os.path.join(tmp, "no.ckpt"), "--device", "cuda",
                "--batch-size", str(BATCH)] + (["--quant", quant] if quant else [])

    reset_counts()
    n = cli.main(argv("synth"))
    torch.cuda.synchronize()
    launches = {**counts(), **int8_counts()}
    no_library(tag)
    log(tag, f"CLI on {os.path.basename(config)}{' --quant ' + quant if quant else ''} "
        f"wrote {n} tiles; launches in the run {launches}")
    path = ("instance_norm", "head_conv", "int8_conv", "int8_norm") if quant \
        else SERVING_KERNELS
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    # int8: the first batch calibrates through one float forward (A's 18
    # calls), then every batch of 4 serves on D and E
    batches = SERVE_TILES // BATCH
    if quant and (launches["trunk_conv"] != EVAL_LAUNCHES["trunk_conv"]
                  or launches["int8_conv"] != batches * INT8_FORWARD["int8_conv"]
                  or launches["int8_norm"] != batches * INT8_FORWARD["int8_norm"]):
        raise AssertionError(f"{tag}: one calibration forward and D and E a "
                             f"forward's a batch: {launches}")
    out = os.path.join(tmp, f"{tag}_synth")
    files = sorted(os.listdir(out))
    if n != SERVE_TILES or len(files) != SERVE_TILES:
        raise AssertionError(f"expected {SERVE_TILES} tiles, got {n} / {len(files)}")
    tiles = [np.load(os.path.join(out, f))["nir"] for f in files]
    for f, t in zip(files, tiles):
        if t.dtype != np.float16 or t.shape != (1, TILE, TILE) or not np.isfinite(t).all():
            raise AssertionError(f"{f}: {t.dtype} {t.shape} finite={np.isfinite(t).all()}")

    # the first batch through the plain path: histogram matching maps both
    # onto the S2 reference's values, so near-tied pixels may swap; PSNR
    # over the reference's range >= 35 dB
    cfg = load_config(config)
    if quant:
        cfg.tpu.serving_quant = quant
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    hr = torch.from_numpy(hr_np[:BATCH]).cuda().permute(0, 2, 3, 1)
    s2 = torch.from_numpy(lr_np[:BATCH, 3:4]).cuda().permute(0, 2, 3, 1)
    with plain_route():
        plain = serve_batch(task, hr, s2, coords=coords[:BATCH] if task.satclip
                            else None).float().cpu().numpy().transpose(0, 3, 1, 2)
    got = np.stack(tiles[:BATCH]).astype(np.float32)
    span = float(plain.max() - plain.min())
    mse = float(np.mean((got - plain) ** 2))
    db = math.inf if mse == 0 else 10 * math.log10(span ** 2 / mse)
    log(tag, f"CLI tiles vs plain path: PSNR {db:.2f} dB over range "
        f"{span:.4f} (bound 35), max|err| {float(np.abs(got - plain).max()):.3e}")
    if not db >= 35.0:
        raise AssertionError(f"serving PSNR {db} < 35")

    # the CLI again in this warm process: wall time of the whole command
    # (config, random init, load, copy, generator, histogram match, fp16,
    # compressed writes)
    t0 = time.perf_counter()
    m = cli.main(argv("timed"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(tag, f"warm CLI rerun: {m} tiles in {dt:.3f} s = {m / dt:.2f} "
        f"tiles/s (batch {BATCH}, set-up included)")
    return launches


def loss_terms(metrics: dict) -> dict:
    from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS

    return {k: float(metrics[k]) for k in LOSS_KEYS}


def check_terms(what: str, got: dict, ref: dict, rtol: float, atol: float) -> None:
    ratio = {k: abs(got[k] - ref[k]) / (atol + rtol * abs(ref[k])) for k in ref}
    worst = max(ratio.values())
    log("train", f"{what}: worst |err| / bound {worst:.3f} ({max(ratio, key=ratio.get)}; "
        f"bound: rtol {rtol:.0e} + atol {atol:.0e}); " + ", ".join(
            f"{k.split('/')[1]} {got[k]:.6g} vs {ref[k]:.6g}" for k in ref))
    if not all(math.isfinite(v) for v in got.values()) or not worst <= 1.0:
        raise AssertionError(f"{what}: {got} vs {ref}")


def first_batch(cfg) -> dict:
    """The first items of the config's train data (the seeded fake dataset)
    through the port's DataModule, as one NCHW batch."""
    from nirgan_tpu_torch.data import dataset_selector

    dm = dataset_selector(cfg)
    items = [dm.train_ds[i] for i in range(dm.train_batch_size)]
    return {k: np.stack([it[k] for it in items])
            for k in ("rgb", "nir", "coords") if k in items[0]}


def check_gradients(task) -> None:
    """A finite, non-zero gradient on every parameter of both networks."""
    for tag, net in (("G", task.netG), ("D", task.netD)):
        bad = [k for k, p in net.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or float(p.grad.abs().max()) == 0.0]
        n = sum(1 for _ in net.parameters())
        log("train", f"{tag}: {n - len(bad)} of {n} parameters have a finite, "
            "non-zero gradient on the kernel path")
        if bad:
            raise AssertionError(f"{tag} parameters without a gradient: {bad}")


# the conv biases of the basic D whose output feeds an instance norm, which
# removes them: their gradient is zero in exact arithmetic (the tests'
# ``_ahead_of_a_norm``)
D_AHEAD = ("conv1.bias", "conv2.bias", "conv3.bias")


def seeded_step(cfg, batch: dict, device, lr: float | None = None, after_d=None,
                mesh=None) -> tuple:
    """One step of ``cfg`` from the seed on ``batch`` (NCHW host arrays):
    (the task, its eight loss terms).  ``lr`` sets both learning rates;
    ``after_d(netD)`` runs right after D's update; ``mesh``: the step over
    that process group."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    task = Px2PxTask(cfg, device=device, seed=SEED).use_mesh(mesh)
    state = task.init_state()
    if lr is not None:
        state.set_lr(lr, lr)
    if after_d is not None:
        update_d = state.opt_d.step

        def step_d():
            update_d()
            after_d(task.netD)

        state.opt_d.step = step_d
    return task, loss_terms(task.train_step(state, task.extract_batch(batch)))


def set_where_flipped(want: dict, lr: float, swapped: list):
    """An ``after_d`` for ``seeded_step``: the elements of D that Adam's
    update moved the other way from ``want`` (more than lr from it) set to
    ``want``'s; appends how many to ``swapped``."""
    def after_d(net):
        with torch.no_grad():
            for k, p in net.named_parameters():
                m = (p - want[k].to(p.device)).abs() > lr
                p[m] = want[k].to(p.device)[m]
                swapped.append(int(m.sum()))

    return after_d


def check_f32_step(name: str, cfg, device: str = "cuda") -> None:
    """One seeded f32 step of ``cfg`` on the card (TF32 off, set here) and
    on the CPU, the step as configured:

    - the seven loss terms other than the G GAN term within rtol 1e-4 +
      atol 1e-6 (f32 sums in other orders);
    - D's gradients, card vs CPU: each tensor within 1e-1 of its largest
      element.  On this batch the real images leave channels of D's deeper
      instance norms with a variance below what f32's E[x^2] - E[x]^2
      resolves, so the normalised values there are rounding noise whose
      sign picks the LeakyReLU's slope: the gradient is discontinuous, and
      two f32 evaluations on one CPU (oneDNN's convolutions and the
      others) lie up to 2.2e-2 of a tensor's largest apart at ``conv3``
      (the flagship), 1.8e-3 (``config_px2px.yaml``), each within 2e-6 of
      f64 on the fake half of the batch.  The biases ahead of an instance
      norm, whose gradient is zero in exact arithmetic, under 1e-5 of the
      network's largest gradient on both sides (the tests' rule,
      ``_ahead_of_a_norm``);
    - D's parameters after its update.  Adam's first update is
      u = sign(g) (1 - eps / (|g| + eps)), so an element whose gradient is
      at least a tenth of its tensor's largest (beyond the bound above) has
      the same sign on both sides, and lies within one f32 step of the
      CPU's (the spacing of f32 at the larger of the two plus 2^-20 lr for
      Adam's roundings) plus lr eps / min |g| (u's dependence on |g|).  Every other
      element within 2 lr; how many there are, and how many went the other
      way, is reported;
    - the G GAN term, which runs through the updated D: the card's step
      again with the elements of D that its update moved the other way
      (more than lr from the CPU's) set to the CPU's values, all eight
      terms within rtol 1e-4 + atol 1e-6.  So the term's distance in the
      plain card step (printed) comes from those elements alone;
    - the card's step repeats: three runs of it from the seed give the same
      eight terms bit for bit (the f32 step runs on cuDNN's deterministic
      algorithms); its time (CUDA events) is printed;
    - a step at LR 0, where G's loss runs through the D both sides share:
      all eight terms within rtol 1e-4 + atol 1e-6.

    ``device`` is the side held against the CPU."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    batch = first_batch(cfg)
    lr = float(cfg.base_configs.lr)

    def step(device, lr=None, after_d=None):
        return seeded_step(cfg, batch, device, lr, after_d)

    cpu, ref = step("cpu")
    ref0 = step("cpu", lr=0.0)[1]
    grad = {k: p.grad for k, p in cpu.netD.named_parameters()}
    want = {k: p.detach() for k, p in cpu.netD.named_parameters()}
    swapped = []
    to_cpu_where_flipped = set_where_flipped(want, lr, swapped)

    gan_key = "model_loss/generator_GAN_loss"
    with cudnn_tf32(False):  # set here, not inherited from an earlier phase
        reset_counts()
        task, got = step(device)
        launched = counts()
        again = [step(device)[1] for _ in range(2)]
        if device == "cuda":
            # the step's time on cuDNN's deterministic algorithms and, in
            # turns, on those cuDNN picks otherwise
            from nirgan_tpu_torch.tasks import px2px

            timed = Px2PxTask(cfg, device=device, seed=SEED)
            state, ex = timed.init_state(), timed.extract_batch(batch)

            def free_step():
                with mock.patch.object(px2px, "_cudnn_deterministic",
                                       lambda on: contextlib.nullcontext()):
                    timed.train_step(state, ex)

            step_ms, free_ms = compare_ms(lambda: timed.train_step(state, ex), free_step,
                                          iters=5)
            del timed
        mixed = step(device, after_d=to_cpu_where_flipped)[1]
        got0 = step(device, lr=0.0)[1]
    # the side held against the CPU: its terms, D's gradients and parameters
    # after the update, the terms with the elements of D that moved the other
    # way set to the CPU's, the terms at LR 0
    hold_f32_step(f"{name}: f32 step 1, card vs CPU (launches {launched})", lr,
                  {"terms": ref, "terms0": ref0, "grads": grad, "params": want},
                  {"terms": got, "terms0": got0, "mixed": mixed, "swapped": sum(swapped),
                   "grads": {k: p.grad.detach() for k, p in task.netD.named_parameters()},
                   "params": {k: p.detach() for k, p in task.netD.named_parameters()}})
    log("train", f"{name}: f32 step 1, the G GAN term on the card over three runs of "
        f"the same step {[round(v[gan_key], 7) for v in [got] + again]} (must repeat "
        "bit for bit)")
    if any(run != got for run in again):
        raise AssertionError(f"{name}: the f32 step on the card does not repeat: {got}, "
                             f"{again}")
    if device == "cuda":
        log("train", f"{name}: the f32 step (TF32 off) {step_ms:.3f} ms on cuDNN's "
            f"deterministic algorithms, {free_ms:.3f} ms on those it picks otherwise")
    if device == "cuda" and min(launched.values()) == 0:
        raise AssertionError(f"the f32 step skipped a kernel: {launched}")


def hold_f32_step(what: str, lr: float, ref: dict, got: dict) -> None:
    """``check_f32_step``'s rule (C9) for one f32 step against another:
    ``ref`` and ``got`` hold the step's eight ``terms``, the ``terms0`` of
    the step at LR 0, D's ``grads`` and its ``params`` after the update;
    ``got`` also the ``mixed`` terms of its step with the elements of D that
    its update moved the other way (more than lr from ``ref``'s) set to
    ``ref``'s, and how many it set (``swapped``)."""
    gan_key = "model_loss/generator_GAN_loss"
    others = {k: v for k, v in ref["terms"].items() if k != gan_key}
    check_terms(f"{what}, all but the G GAN term",
                {k: got["terms"][k] for k in others}, others, 1e-4, 1e-6)

    # D's gradients and its parameters after its update
    grad, want = ref["grads"], ref["params"]
    near0 = {k: (g.abs() < 1e-1 * g.abs().max()) | (k in D_AHEAD) for k, g in grad.items()}
    net_max = max(float(g.abs().max()) for g in grad.values())
    g_err, noise = (0.0, ""), 0.0
    worst, n_near, n_flip, n_sign, near_max, n_all = (0.0, ""), 0, 0, 0, 0.0, 0
    for k, g_got in got["grads"].items():
        g_dev, g_cpu = g_got.cpu().double(), grad[k].cpu().double()
        p_got, p_ref = got["params"][k].cpu(), want[k].cpu()
        if k in D_AHEAD:
            noise = max(noise, float(torch.maximum(g_dev.abs(), g_cpu.abs()).max()) / net_max)
        else:
            g_err = max(g_err, (float((g_dev - g_cpu).abs().max() / g_cpu.abs().max()), k))
        d = (p_got.double() - p_ref.double()).abs()
        w = torch.maximum(p_ref.abs(), p_got.abs())
        # the spacing of f32 at the larger of the two: 2^(exponent - 24),
        # mantissa in [0.5, 1)
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 24).double()
        bound = ulp + lr * (2.0 ** -20 + 1e-8 / torch.minimum(g_dev.abs(), g_cpu.abs()))
        near = near0[k].cpu()
        real = ~near
        n_sign += int((torch.sign(g_dev) != torch.sign(g_cpu))[real].sum())
        if real.any() and float((d / bound)[real].max()) > worst[0]:
            worst = (float((d / bound)[real].max()), k)
        n_all += p_got.numel()
        n_near += int(near.sum())
        n_flip += int((d[near] > lr).sum())
        if near.any():
            near_max = max(near_max, float(d[near].max()) / lr)
    log("train", f"{what}, D's gradients: worst {g_err[0]:.2e} of the tensor's largest "
        f"({g_err[1]}; bound 1e-1), the biases ahead of a norm {noise:.2e} of the largest "
        f"(bound 1e-5); D's {n_all} parameters after the update: {n_all - n_near} with a "
        f"gradient of at least 1e-1 of their tensor's largest, {n_sign} of them of the "
        f"other sign (bound 0), worst |err| / (one f32 step + 2^-20 lr + lr eps / min "
        f"|g|) {worst[0]:.3f} ({worst[1]}); the other {n_near}: {n_flip} moved the other "
        f"way, the largest |err| {near_max:.3f} lr (bound 2 lr)")
    if not (g_err[0] <= 1e-1 and noise <= 1e-5 and n_sign == 0 and worst[0] <= 1.0
            and near_max <= 2.0 * 1.01):
        raise AssertionError(f"{what}, D after the f32 step: gradients {g_err}, {noise}; "
                             f"parameters {n_sign}, {worst}, {near_max} lr")
    gan_ratio = (abs(got["terms"][gan_key] - ref["terms"][gan_key])
                 / (1e-6 + 1e-4 * abs(ref["terms"][gan_key])))
    log("train", f"{what}, the G GAN term through the updated D: {got['terms'][gan_key]:.7g} "
        f"vs {ref['terms'][gan_key]:.7g} ({gan_ratio:.3f} of rtol 1e-4)")
    check_terms(f"{what}, with the {got['swapped']} elements of D that its update moved "
                "the other way set to the reference's", got["mixed"], ref["terms"],
                1e-4, 1e-6)
    check_terms(f"{what}, at LR 0", got["terms0"], ref["terms0"], 1e-4, 1e-6)


def held_step(name: str, cfg, batch: dict) -> dict:
    """One fused step of ``cfg`` from the seed on ``batch`` (NCHW host
    arrays), bf16 on the kernels: launches equal ``STEP_LAUNCHES`` and the
    trunk backward's pads ``PAD_STEP_LAUNCHES``, no
    library route, a finite non-zero gradient on every parameter; the same
    seeded step again bit for bit (every sum on the path runs in a fixed
    order); its loss terms within 2% + 1e-3 of the plain route's.  The
    peak device memory of the kernels' step counts from before its task is
    built.  Returns the task, its state, the batch on the card, the plain
    route's task and state, the step's metrics and terms, its launches, its
    peak bytes and the shape of the generator's input in the step."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    state = task.init_state()
    ex = task.extract_batch(batch)
    seen = []
    hook = task.netG.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape))
    reset_counts()
    metrics = task.train_step(state, ex)
    got = loss_terms(metrics)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    hook.remove()
    per_step, pads = counts(), pad_counts()
    no_library(f"{name}: step")
    log("train", f"{name}: launches per step {per_step} (want {STEP_LAUNCHES}), the trunk "
        f"backward's pads {pads} (want {PAD_STEP_LAUNCHES})")
    if per_step != STEP_LAUNCHES or pads != PAD_STEP_LAUNCHES:
        raise AssertionError(f"launches {per_step}, {pads} != {STEP_LAUNCHES}, "
                             f"{PAD_STEP_LAUNCHES}")
    check_gradients(task)
    again = Px2PxTask(cfg, device="cuda", seed=SEED)
    repeat = loss_terms(again.train_step(again.init_state(), ex))
    differ = [f"{tag}.{k}" for tag, a, b in (("G", task.netG, again.netG),
                                             ("D", task.netD, again.netD))
              for (k, p), q in zip(a.named_parameters(), b.parameters())
              if not torch.equal(p.grad, q.grad)]
    log("train", f"the step again from the same seed: {len(differ)} gradients "
        f"differ, terms equal: {repeat == got}")
    if differ or repeat != got:
        raise AssertionError(f"the step did not repeat: {differ}, {repeat} vs {got}")
    del again
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain_state = plain.init_state()
    with plain_route():
        ref = loss_terms(plain.train_step(plain_state, ex))
    # bf16 activations on both routes, rounded at other points; the serving
    # forward measured 47 dB between them; the terms are means over
    # thousands of logits or pixels: within 2% + 1e-3
    check_terms(f"{name}: bf16 step 1, kernels vs plain route", got, ref, 2e-2, 1e-3)
    return {"task": task, "state": state, "ex": ex, "plain": plain,
            "plain_state": plain_state, "metrics": metrics, "terms": got,
            "per_step": per_step, "pads": pads, "peak": peak, "g_input": tuple(seen[0])}


def steps_ms(task, state, batches, n: int = 8) -> float:
    """ms a step over ``n`` steps (CUDA events, after a warm round):
    ``batches()`` gives the round's n batches, which the steps take in
    turn."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in ("warm", "timed"):
        torch.cuda.synchronize()
        marks[0].record()
        for b in batches():
            task.train_step(state, b)
        marks[1].record()
        marks[1].synchronize()
    return marks[0].elapsed_time(marks[1]) / n


def run_train_cli(name: str, run: str, argv: list, steps: int, val_steps: list,
                  n_eval: int, satclip: bool = False) -> tuple[dict, list]:
    """``python -m nirgan_tpu_torch.train`` (its ``main``) with ``argv``
    for ``steps`` steps into ``run``: the launches equal ``steps`` steps'
    and ``n_eval`` validation batches' forwards, no library route; the
    checkpoints, the scheduler's state and the config written (on the
    flagship, ``satclip``, also the ``save_val_df`` sweep's files); a row of
    finite loss terms every step, validation rows at ``val_steps``, one
    panel a validation.  Returns the launches and the train rows."""
    from nirgan_tpu_torch.tasks.px2px import LOSS_KEYS
    from nirgan_tpu_torch.train import cli

    reset_counts()
    t0 = time.perf_counter()
    final = cli.main(argv + ["--logdir", run, "--max-steps", str(steps)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    no_library(f"{name}: CLI")
    want = {k: steps * STEP_LAUNCHES[k] + n_eval * EVAL_LAUNCHES[k] for k in STEP_LAUNCHES}
    log("train", f"CLI {' '.join(argv)}: {final.step} steps in {dt:.2f} s (set-up "
        f"included); launches {launches} (want {want})")
    if final.step != steps or launches != want:
        raise AssertionError(f"CLI run: step {final.step}, launches {launches}")
    missing = [f for f in ("last.pt", "best.pt", "sched_state_last.json",
                           "sched_state_best.json", "config.yaml")
               + (("validation_metrics.csv",
                   "validation_metrics_ablation_satclip_True_e1.geojson") * satclip)
               if not os.path.isfile(os.path.join(run, f))]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "model_loss/generator_total_loss" in r]
    val = [r for r in rows if "val/L1" in r]
    keys = list(LOSS_KEYS) + (["scale_param"] if satclip else [])
    finite = all(math.isfinite(r[k]) for r in train for k in keys)
    log("train", f"CLI: train rows at steps {[r['step'] for r in train]}, val "
        f"rows at {[r['step'] for r in val]}; generator_total_loss "
        f"{train[0]['model_loss/generator_total_loss']:.4f} -> "
        f"{train[-1]['model_loss/generator_total_loss']:.4f}; val/L1 "
        f"{[round(r['val/L1'], 5) for r in val]}; images/s (host clock, steps "
        f"2-{steps}) {[round(r['perf/images_per_sec'], 1) for r in train[1:]]}"
        + (f"; scale_param {[round(r['scale_param'], 5) for r in train]}"
           if satclip else ""))
    # the validation panels, drawn with PIL where matplotlib is not installed
    images = sorted(f for f in os.listdir(os.path.join(run, "images"))
                    if f.startswith("Images_Val_NIR_")) if os.path.isdir(
        os.path.join(run, "images")) else []
    log("train", f"CLI: validation panels {images}")
    if (missing or not finite or [r["step"] for r in val] != val_steps
            or len(train) != steps or len(images) != len(val_steps)):
        raise AssertionError(f"CLI run: missing {missing}, finite {finite}, "
                             f"val steps {[r['step'] for r in val]}, panels {images}")
    return launches, train


def phase_train(tmp: str, satclip: bool = False) -> tuple[dict, dict]:
    """The training path of ``config_px2px.yaml`` or (``satclip``) of the
    flagship ``config_px2px_SatCLIP.yaml``, whose CLI run takes the CLI's
    default arguments.  Returns the launches of the training CLI's run and
    of one step."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data.pipeline import DeviceFeed
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train import cli

    config = SATCLIP_CONFIG if satclip else CONFIG
    name = os.path.basename(config)
    n_batch = SATCLIP_BATCH if satclip else TRAIN_BATCH

    # --- one fused step of the full-width config, kernels vs plain route
    cfg = load_config(config)
    batch = first_batch(cfg)
    if batch["rgb"].shape != (n_batch, 3, TRAIN_TILE, TRAIN_TILE):
        raise AssertionError(f"train batch {batch['rgb'].shape}")

    held = held_step(name, cfg, batch)
    task, state, ex = held["task"], held["state"], held["ex"]
    plain, plain_state, got = held["plain"], held["plain_state"], held["terms"]
    per_step = held["per_step"]
    if satclip and tuple(ex["embeds"].shape) != (n_batch, 256):
        raise AssertionError(f"embeds {tuple(ex['embeds'].shape)}")
    if satclip:
        # the learnable scale moved off its init by Adam's first step
        scale = float(held["metrics"]["scale_param"])
        log("train", f"scale_param after the step: {scale:.6f} (init "
            f"{float(cfg.satclip.scaling_param_init)})")
        if not (math.isfinite(scale) and scale != float(cfg.satclip.scaling_param_init)):
            raise AssertionError(f"scale_param did not move: {scale}")
    # the batch through DeviceFeed, prepared in line (depth 0) and on its
    # producer thread (depth 1): the same step bit for bit
    for depth in (0, 1):
        fed = Px2PxTask(cfg, device="cuda", seed=SEED)
        fed_batch = next(iter(DeviceFeed([batch], fed.extract_batch, depth=depth)))
        fed_terms = loss_terms(fed.train_step(fed.init_state(), fed_batch))
        differ = [f"{tag}.{k}" for tag, a, b in (("G", fed.netG, task.netG),
                                                 ("D", fed.netD, task.netD))
                  for (k, p), q in zip(a.named_parameters(), b.parameters())
                  if not torch.equal(p.grad, q.grad)]
        log("train", f"the step fed through DeviceFeed(depth={depth}): "
            f"{len(differ)} gradients differ from the inline step, terms equal: "
            f"{fed_terms == got}")
        if differ or fed_terms != got:
            raise AssertionError(f"the fed step (depth {depth}) is not the inline "
                                 f"step: {differ}, {fed_terms} vs {got}")
        del fed, fed_batch

    def plain_step():
        with plain_route():
            plain.train_step(plain_state, ex)

    ms, plain_ms = compare_ms(lambda: task.train_step(state, ex), plain_step,
                              iters=5)
    log("train", f"{name}: bf16 fused step, batch {n_batch} at {TRAIN_SIDE}^2: "
        f"kernels {ms:.3f} ms ({n_batch / ms * 1e3:.2f} images/s), plain "
        f"{plain_ms:.3f} ms ({n_batch / plain_ms * 1e3:.2f} images/s)")
    # what a trainer's step costs beyond the bare step: the batch's copies
    # to the card in ``extract_batch`` and, on the SatCLIP route, the tower
    # (float64 on the host), either in line or done ahead by the loader's
    # thread (``embed_coords``), as ``Trainer.fit`` has it
    ready = task.embed_coords(batch)
    fed_ms = time_ms(lambda: task.train_step(state, task.extract_batch(ready)), iters=5)
    log("train", f"{name}: extract_batch + step{', embeddings made ahead' * satclip}: "
        f"{fed_ms:.3f} ms ({n_batch / fed_ms * 1e3:.2f} images/s)")

    # 8 steps "bare" on the batch already on the card, "inline" with
    # ``extract_batch`` before each step, or fed through DeviceFeed at the
    # depth 0 or 1; the host's pace moves a step by several ms from one
    # round to the next: the four ways in turns, three rounds, the median of
    # each
    ways = {"bare": lambda: [ex] * 8,
            "inline": lambda: (task.extract_batch(ready) for _ in range(8)),
            0: lambda: DeviceFeed([ready] * 8, task.extract_batch, depth=0),
            1: lambda: DeviceFeed([ready] * 8, task.extract_batch, depth=1)}
    rounds = [[steps_ms(task, state, way) for way in ways.values()] for _ in range(3)]
    fed = dict(zip(ways, np.median(np.asarray(rounds), axis=0)))
    log("train", f"{name}: 8 steps each way, three rounds in turns, medians (CUDA "
        f"events): bare {fed['bare']:.3f} ms, extract_batch in line "
        f"{fed['inline']:.3f}, DeviceFeed depth 0 {fed[0]:.3f}, depth 1 "
        f"{fed[1]:.3f}; rounds {np.round(rounds, 2).tolist()}")
    if satclip:
        inline_ms = time_ms(lambda: task.train_step(state, task.extract_batch(batch)),
                            iters=5)
        t0 = time.perf_counter()
        for _ in range(10):
            task.embed_coords(batch)
        log("train", f"{name}: extract_batch + step with the tower in line: "
            f"{inline_ms:.3f} ms ({n_batch / inline_ms * 1e3:.2f} images/s); the "
            f"tower alone {(time.perf_counter() - t0) * 100:.3f} ms a batch of "
            f"{n_batch} (host clock)")
    del task, plain, state, plain_state, ex, held
    torch.cuda.empty_cache()

    # --- an f32 step on the card (TF32 off) vs the same seeded step on the
    # CPU, at 64^2 (the head kernel needs ngf 64; the inject generator has 9
    # blocks, the plain route takes 6)
    small = load_config(config)
    small.tpu.compute_dtype = "float32"
    if not satclip:
        small.base_configs.netG = "resnet_6blocks"
    small.Data.train_batch_size = 2
    small.Data.fake_settings.image_size = 64
    check_f32_step(name, small)

    # --- the training CLI: 8 steps, then a resume for 2 more.  The plain
    # config has 4 steps an epoch (validations at 4 and 8, one batch each);
    # the SatCLIP config, run by the CLI's default arguments, 8 steps an
    # epoch (one validation at 8, one batch, then its save_val_df sweep:
    # one batch of 8)
    run = os.path.join(tmp, "run_satclip" if satclip else "run")
    argv = ["--log-every", "1"] if satclip else ["--config", CONFIG, "--device",
                                                 "cuda", "--log-every", "1"]
    val_steps, n_eval = ([8], 1 + 1) if satclip else ([4, 8], 2)
    launches, _ = run_train_cli(name, run, argv, 8, val_steps, n_eval, satclip)
    resumed = cli.main(argv + ["--resume", run, "--max-steps", "10"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        val = [json.loads(line)["step"] for line in f if "val/L1" in line]
    log("train", f"CLI resume: {resumed.step} steps, val rows at {val}")
    if resumed.step != 10 or val != val_steps + [10]:
        raise AssertionError(f"resume: step {resumed.step}, val rows {val}")
    return launches, per_step


# ------------------------------------------------- training on 512^2 tiles
# config_px2px.yaml's S2_75k_settings and S2_100k_settings: the reference's
# Sentinel-2 datasets, 512^2 tiles reflect-padded to 532^2, batch 16
T512_TILE = 512
T512_SIDE = T512_TILE + 2 * PAD  # 532
# seeded uint16 RGBN tiles: the loader holds out every 17th of 69 for
# validation, which leaves 64 (four batches of 16, one epoch) and 5 (one
# batch at val_batch_size 5)
T512_TILES = 69
T512_F32_BATCH = 2  # the f32 step's batch, card against the CPU
T512_STEPS = 4  # the train CLI's steps: one epoch, one validation
T512_TIMED = 8  # steps a round of the step's timing


def write_s2_tiles(folder: str, n: int = T512_TILES) -> None:
    """``n`` seeded uint16 DN (4, 512, 512) RGBN ``.npy`` tiles, the layout
    that ``NpzFolderDataset`` and the native reader read."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for i in range(n):
        np.save(os.path.join(folder, f"s2_{i:03d}.npy"),
                rng.integers(0, 10000, (4, T512_TILE, T512_TILE), dtype=np.uint16))


def s2_config(folder: str, **data):
    """``config_px2px.yaml`` in memory with ``dataset_type: S2_75k``, its
    ``base_path`` the folder of ``write_s2_tiles``, and the ``Data`` values
    given."""
    from nirgan_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.Data.dataset_type = "S2_75k"
    cfg.Data.S2_75k_settings.base_path = folder
    for key, value in data.items():
        cfg.Data[key] = value
    return cfg


def s2_norm_shapes() -> list:
    """The instance norm's shapes in the 532^2 step at batch 16, with the
    fused ReLU the step gives each and whether a skip is fused there: G at
    532^2 (c0, u1), 266^2 (d0, u0) and 133^2 (d1 and the blocks' norm1;
    the blocks' norm2 with the skip); the PatchGAN on 512^2 at 128^2,
    64^2 and 63^2 (C = 512), whose LeakyReLU is not fused."""
    n, s, t = TRAIN_BATCH, T512_SIDE, T512_TILE
    return [((n, s, s, 64), True, False), ((n, s // 2, s // 2, 128), True, False),
            ((n, s // 4, s // 4, 256), True, True), ((n, t // 4, t // 4, 128), False, False),
            ((n, t // 8, t // 8, 256), False, False),
            ((n, t // 8 - 1, t // 8 - 1, 512), False, False)]


def bf16_db(got: torch.Tensor, ref: torch.Tensor) -> float:
    """PSNR of a bf16 result against its plain version over the plain
    version's range."""
    r = ref.float()
    return psnr(got, ref, float(r.max() - r.min()))


def train512_kernels(g: torch.Generator) -> dict:
    """Every kernel of the 532^2 step against its plain version at the
    step's shapes, f32 and bf16 by the helpers' bounds, bf16 also >= 40 dB,
    each timed beside its plain version, its library call and its bound: A
    at (16, 133^2, 256), both pad modes; B and B4 at the six norm shapes
    (``s2_norm_shapes``) with the ReLU and the skip fused and not, and at
    532^2 without the ReLU beside the library calls; B5 at u1 (z (16,
    266^2, 128), ct (16, 532^2, 64)) and u0 (z (16, 133^2, 256), ct (16,
    266^2, 128)); C at (16, 538^2, 64).  The entries go under
    ``train512`` in the kernels' JSON entries."""
    from nirgan_tpu_torch.ops.head_conv import head_conv_cuda, head_conv_plain
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_bwd_cuda,
        instance_norm_bwd_plain,
        instance_norm_cuda,
        instance_norm_plain,
    )
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda, trunk_conv_plain

    dev = torch.device("cuda")
    n, s = TRAIN_BATCH, T512_SIDE
    out, dbs = {}, {}
    # A, and its dB on a fresh input at the shape
    shape = (n, s // 4, s // 4, 256)
    err, *a_times, a_valid = check_trunk(g, shape)
    xb = torch.randn(shape, device=dev, generator=g).bfloat16()
    w = torch.randn((256, 256, 3, 3), device=dev, generator=g) / 48.0
    dbs["trunk_conv"] = bf16_db(trunk_conv_cuda(xb, w), trunk_conv_plain(xb, w))
    out["trunk_conv"] = {"err": err, "train512": times(shape, *a_times),
                         "pad0_train512": times(*a_valid)}
    # C
    shape = (n, s + 6, s + 6, 64)
    err, *c_times = check_head(g, shape)
    xb = torch.randn(shape, device=dev, generator=g).bfloat16()
    w = torch.randn((1, 64, 7, 7), device=dev, generator=g) / 56.0
    b = torch.full((1,), 0.1, device=dev)
    dbs["head_conv"] = bf16_db(head_conv_cuda(xb, w, b), head_conv_plain(xb, w, b))
    out["head_conv"] = {"err": err, "train512": times(shape, *c_times)}
    del xb, w
    # B5 at u1 and u0
    u1 = check_convt(g, "train512_u1", n, s // 2, 128, 64)
    u0 = check_convt(g, "train512_u0", n, s // 4, 256, 128)
    out["convt_bwd"] = {"err": max(u1[0], u0[0]), "train512_u1": times(*u1[1]),
                        "train512_u0": times(*u0[1])}
    # B and B4
    fwd, bwd, worst, worst_bwd = [], [], 0.0, 0.0
    for shape, relu, skip in s2_norm_shapes():
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        r = torch.randn(shape, device=dev, generator=g) if skip else None
        dy = torch.randn(shape, device=dev, generator=g)
        for fused_relu in (False, True):
            for residual in (None, r) if skip else (None,):
                worst = max(worst, check_norm(x, fused_relu, residual))
            worst_bwd = max(worst_bwd, check_norm_bwd(x, dy, fused_relu))
        del r
        xb, gb = x.bfloat16(), dy.bfloat16()
        del x, dy
        y, stats = instance_norm_cuda(xb, relu=relu, return_stats=True)
        db = bf16_db(y, instance_norm_plain(xb, relu=relu))
        db_bwd = bf16_db(instance_norm_bwd_cuda(xb, gb, stats, relu),
                         instance_norm_bwd_plain(xb, gb, stats, relu))
        del y, stats
        log("train512", f"instance_norm {shape} relu={relu}: bf16 kernels vs plain "
            f"{db:.2f} dB forward, {db_bwd:.2f} dB backward (bound 40)")
        dbs[f"instance_norm {shape}"], dbs[f"instance_norm_bwd {shape}"] = db, db_bwd
        fwd.append(times(shape, *norm_times(xb, relu)))
        bwd.append(times(shape, *bwd_times(xb, gb, relu)))
        if skip:
            fwd.append(times(shape, *norm_times(xb, False, skip=True)))
        if shape[1] == s:
            # G's 532^2 norm without the ReLU too, beside the library calls,
            # which fuse no ReLU
            fwd.append(times(shape, *norm_times(xb, False)))
            bwd.append(times(shape, *bwd_times(xb, gb, False)))
        del xb, gb
        torch.cuda.empty_cache()
    out["instance_norm"] = {"err": worst, "train512_shapes": fwd}
    out["instance_norm_bwd"] = {"err": worst_bwd, "train512_shapes": bwd}
    log("train512", f"bf16 kernels vs plain at the 532^2 step's shapes, dB: "
        f"{ {k: round(v, 2) for k, v in dbs.items()} }")
    shares = [e["bound_ms"] / e["ms"] for e in fwd + bwd]
    if min(dbs.values()) < 40.0 or max(shares) > 1.0:
        raise AssertionError(f"train512 kernels: {dbs}, shares {shares}")
    return out


# odd shapes of the trunk backward's pads: ragged blocks, channels that are
# not a power of two, H or W = 2 and 3 (where a row or column takes both of
# its side's mirrors), channels that fill no 16-byte vector (one element a
# thread)
PAD_ODD_SHAPES = ((3, 15, 13, 128), (5, 17, 19, 96), (2, 2, 9, 64), (2, 7, 2, 8),
                  (1, 2, 2, 256), (4, 3, 3, 32), (2, 3, 11, 24), (2, 7, 9, 12),
                  (3, 5, 6, 3), (1, 4, 3, 1))


def wide(g: torch.Generator, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """Normal values scaled by powers of two from 2^-8 to 2^8, so that the
    adjoint's every rounding counts."""
    dev = torch.device("cuda")
    scale = torch.exp2(torch.randint(-8, 9, shape, device=dev, generator=g).float())
    return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)


def pads_equal(g: torch.Generator, shape: tuple, dtype: torch.dtype,
               unaligned: bool = False) -> tuple:
    """The pad kernel on x of ``shape`` and the adjoint kernel on a padded
    cotangent against the plain ops on the card, bit for bit; returns x and
    the cotangent.  ``unaligned``: both inputs one element past a 16-byte
    boundary, so the kernels move one element a thread."""
    from nirgan_tpu_torch.ops import reflect_pad as rp

    b, h, w, c = shape
    x, gp = wide(g, shape, dtype), wide(g, (b, h + 2, w + 2, c), dtype)
    if unaligned:
        x, gp = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape) for t in (x, gp))
        assert x.data_ptr() % 16 and gp.data_ptr() % 16 and x.is_contiguous()
    xp, dx = rp.reflect_pad_cuda(x), rp.reflect_pad_adjoint_cuda(gp)
    xp_ref, dx_ref = rp.reflect_pad_plain(x), rp.reflect_pad_adjoint_plain(gp)
    torch.cuda.synchronize()
    bad = {what: int((got != ref).sum()) if got.shape == ref.shape else -1
           for what, got, ref in (("pad", xp, xp_ref), ("adjoint", dx, dx_ref))}
    if any(bad.values()) or not (xp.is_contiguous() and dx.is_contiguous()):
        raise AssertionError(f"reflect pad {shape} {dtype}: elements apart from the plain "
                             f"ops {bad}")
    return x, gp


def phase_reflect_pad() -> dict:
    """The trunk backward's reflect pad and its adjoint
    (``ops/reflect_pad.py``): bit for bit with the plain ops they replace
    (``reflect_pad2d`` and ``reflect_pad2d_adjoint`` at pad 1, run on the
    card) at the 532^2 step's trunk shape (16, 133^2, 256) and the 276^2
    step's (16, 69^2, 256) in bf16, and at ``PAD_ODD_SHAPES`` and (2,
    133^2, 256) in bf16, f32 and f16, aligned and one element past a 16-byte
    boundary; then each kernel timed at those two shapes over rotated inputs
    beside the plain ops, the one library call (ATen's reflect pad, which
    writes NCHW; its backward, which adds with atomics) and the byte bound
    (each input read once, each output written once)."""
    from nirgan_tpu_torch.ops import reflect_pad as rp
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    n, s = TRAIN_BATCH, T512_SIDE
    shapes = ((n, s // 4, s // 4, 256), (n, TRAIN_SIDE // 4, TRAIN_SIDE // 4, 256))
    for shape in PAD_ODD_SHAPES + ((2, s // 4, s // 4, 256),):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            for unaligned in (False, True):
                pads_equal(g, shape, dtype, unaligned)
    log("reflect_pad", f"pad and adjoint bit for bit with the plain ops at {PAD_ODD_SHAPES} "
        f"and (2, {s // 4}^2, 256), bf16, f32 and f16, aligned and not")

    def aten_pad(x):
        return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def aten_adjoint(gp, x):
        return torch.ops.aten.reflection_pad2d_backward(gp.permute(0, 3, 1, 2),
                                                       x.permute(0, 3, 1, 2), [1, 1, 1, 1])

    out = {}
    for shape in shapes:
        x, gp = pads_equal(g, shape, torch.bfloat16)
        moved = nbytes(x, gp)
        pad_sets, adj_sets = rotation(x), rotation(gp, x)
        del x, gp
        # each call takes a set: (x,) for the pad, (gp, x) for the adjoint
        for name, fns, sets in (
                ("reflect_pad", (rp.reflect_pad_cuda, rp.reflect_pad_plain, aten_pad),
                 pad_sets),
                ("reflect_pad_adjoint", (lambda gp, x: rp.reflect_pad_adjoint_cuda(gp),
                                         lambda gp, x: rp.reflect_pad_adjoint_plain(gp),
                                         aten_adjoint), adj_sets)):
            ms, plain_ms, library_ms = compare_ms(*(rotating(fn, sets) for fn in fns),
                                                  run_ahead=True)
            bound = least_time(0.0, moved)
            log("reflect_pad", f"{name} {shape} bf16: {ms:.4f} ms, bound {bound[0]:.4f} "
                f"({bound[0] / ms:.1%}), plain ops {plain_ms:.4f}, library call "
                f"{library_ms:.4f}")
            if bound[0] > ms:
                raise AssertionError(f"{name} {shape}: {ms} ms under its bound {bound}")
            out.setdefault(name, []).append(times(shape, ms, plain_ms, library_ms, bound))
        del pad_sets, adj_sets
        torch.cuda.empty_cache()
    return out


def pads_in_step(name: str, cfg, ex: dict) -> None:
    """One seeded step on the kernels and the same step with the trunk
    backward's pad and adjoint on the plain ops (``plain_pads``): every
    gradient and parameter of G and D and the loss terms bit for bit, the
    pads launched 18 + 18 on the kernels' side and none on the other."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    tasks, terms, launched = [], [], []
    for plain in (False, True):
        task = Px2PxTask(cfg, device="cuda", seed=SEED)
        reset_counts()
        with plain_pads() if plain else contextlib.nullcontext():
            terms.append(loss_terms(task.train_step(task.init_state(), ex)))
        torch.cuda.synchronize()
        launched.append(pad_counts())
        tasks.append(task)
    differ = [f"{tag}.{k}" for tag, a, b in (("G", tasks[0].netG, tasks[1].netG),
                                             ("D", tasks[0].netD, tasks[1].netD))
              for (k, p), q in zip(a.named_parameters(), b.parameters())
              if not (torch.equal(p.grad, q.grad) and torch.equal(p, q))]
    n = sum(1 for net in (tasks[0].netG, tasks[0].netD) for _ in net.parameters())
    log("train512", f"{name}: the step with the pad kernels against the plain pads: "
        f"{len(differ)} of {n} gradients or parameters differ, terms equal: "
        f"{terms[0] == terms[1]}; pads launched {launched}")
    quiet = {k: 0 for k in PAD_STEP_LAUNCHES}
    if differ or terms[0] != terms[1] or launched != [PAD_STEP_LAUNCHES, quiet]:
        raise AssertionError(f"{name}: the pads moved the step: {differ}, {terms}, {launched}")


def phase_train512(tmp: str) -> dict:
    """Training on 512^2 tiles, the S2 datasets' configuration
    (``S2_75k_settings``, ``config_px2px.yaml:39-48``; batch 16, reflect-
    padded to 532^2, bf16 over f32 params): seeded uint16 RGBN ``.npy``
    tiles in a folder, ``config_px2px.yaml`` in memory with
    ``dataset_type: S2_75k`` pointed at it.  Every kernel against its plain
    version at the step's shapes (``train512_kernels``); the batch
    (16, 3, 512^2) and the generator's input in the step 532^2; one fused
    step at batch 16 (``held_step``: launches, gradients, bit for bit again,
    the plain route's terms), its peak device memory from before its task,
    its ms by CUDA events (the median of three rounds of ``T512_TIMED`` steps,
    and one of the plain route); the f32 step card against the CPU at batch
    ``T512_F32_BATCH`` of 512^2 (``check_f32_step``, TF32 off); the train CLI
    for one epoch of ``T512_STEPS`` steps and a validation at
    ``val_batch_size`` 5 of 512^2, fed by the Python loader and by the
    native reader (``Data.native_loader``): launches, files, rows, panels,
    ``perf/step_ms`` and ``perf/images_per_sec``.  Returns the numbers for
    the JSON line."""
    from nirgan_tpu_torch.config import save_config

    folder = os.path.join(tmp, "s2_75k")
    t0 = time.perf_counter()
    write_s2_tiles(folder)
    cfg = s2_config(folder)
    name = f"{os.path.basename(CONFIG)} S2_75k {T512_TILE}^2"
    log("train512", f"{T512_TILES} seeded uint16 (4, {T512_TILE}, {T512_TILE}) tiles written "
        f"in {time.perf_counter() - t0:.1f} s; {name} (configs/config_px2px.yaml:39-48), batch "
        f"{cfg.Data.train_batch_size}, padding {cfg.Data.padding_amount}")
    t0 = time.perf_counter()
    with cudnn_tf32(False):
        kernels = train512_kernels(torch.Generator(device="cuda").manual_seed(SEED))
    pads = phase_reflect_pad()
    kernels_s = time.perf_counter() - t0

    # --- one fused step at batch 16, kernels vs plain route
    t0 = time.perf_counter()
    batch = first_batch(cfg)
    held = held_step(name, cfg, batch)
    task, state, ex = held["task"], held["state"], held["ex"]
    log("train512", f"batch {batch['rgb'].shape} {batch['rgb'].dtype}, the generator's "
        f"input in the step {held['g_input']}; peak device memory of the step "
        f"{held['peak']} B from before its task")
    if (batch["rgb"].shape != (TRAIN_BATCH, 3, T512_TILE, T512_TILE)
            or held["g_input"] != (TRAIN_BATCH, T512_SIDE, T512_SIDE, 3)):
        raise AssertionError(f"512^2 batch {batch['rgb'].shape}, input {held['g_input']}")
    plain, plain_state = held["plain"], held["plain_state"]
    rounds = [steps_ms(task, state, lambda: [ex] * T512_TIMED, T512_TIMED) for _ in range(3)]
    ms = float(np.median(rounds))

    def plain_step():
        with plain_route():
            plain.train_step(plain_state, ex)

    plain_ms = time_ms(plain_step, iters=3, warmup=1)
    log("train512", f"bf16 fused step, batch {TRAIN_BATCH} at {T512_SIDE}^2 (CUDA events): "
        f"median of three rounds of {T512_TIMED} {ms:.3f} ms ({TRAIN_BATCH / ms * 1e3:.2f} "
        f"images/s; rounds {[round(r, 3) for r in rounds]}), plain route {plain_ms:.3f} ms")
    step_s = time.perf_counter() - t0
    per_step, pads_per_step, peak = held["per_step"], held["pads"], held["peak"]
    del task, state, plain, plain_state, held
    torch.cuda.empty_cache()
    pads_in_step(name, cfg, ex)
    del ex
    torch.cuda.empty_cache()

    # --- the f32 step, card against the CPU, at batch 2 of 512^2
    t0 = time.perf_counter()
    small = s2_config(folder, train_batch_size=T512_F32_BATCH)
    small.tpu.compute_dtype = "float32"
    check_f32_step(f"{name} batch {T512_F32_BATCH}", small)
    f32_s = time.perf_counter() - t0

    # --- the train CLI for one epoch and its validation, on both readers
    t0 = time.perf_counter()
    cli_out = {}
    for route, native in (("python", False), ("native", True)):
        path = os.path.join(tmp, f"s2_{route}.yaml")
        save_config(s2_config(folder, native_loader=native), path)
        _, rows = run_train_cli(f"{name}, {route} loader", os.path.join(tmp, f"run512_{route}"),
                                ["--config", path, "--device", "cuda", "--log-every", "1"],
                                T512_STEPS, [T512_STEPS], 1)
        cli_out[route] = {k: [r[k] for r in rows[1:]]
                          for k in ("perf/step_ms", "perf/images_per_sec")}
        log("train512", f"CLI on the {route} loader: perf/step_ms "
            f"{[round(v, 2) for v in cli_out[route]['perf/step_ms']]}, perf/images_per_sec "
            f"{[round(v, 2) for v in cli_out[route]['perf/images_per_sec']]} (steps 2-"
            f"{T512_STEPS}, the host's clock)")
    cli_s = time.perf_counter() - t0
    log("train512", f"kernels {kernels_s:.1f} s, the step {step_s:.1f} s, the f32 step "
        f"{f32_s:.1f} s, the CLI runs {cli_s:.1f} s")
    for name_, got in kernels.items():
        if name_ in RESULTS:
            RESULTS[name_].update({k: v for k, v in got.items() if k != "err"})
            RESULTS[name_]["max_abs_err"] = max(RESULTS[name_]["max_abs_err"], got["err"])
    return {"step_ms": ms, "step_ms_rounds": rounds, "plain_step_ms": plain_ms,
            "peak_bytes": peak, "per_step": per_step, "cli": cli_out,
            "batch": TRAIN_BATCH, "side": T512_SIDE, "reflect_pad": pads,
            "pads_per_step": pads_per_step}


def phase_concat() -> None:
    """The SatCLIP concat route (the embedding plane as a 4th input channel,
    a 5-channel discriminator) at full width with 6 blocks: one forward and
    one fused step, kernels vs plain route."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = load_config(SATCLIP_CONFIG)
    cfg.satclip.satclip_style = "concat"
    cfg.base_configs.netG = "resnet_6blocks"
    batch = first_batch(cfg)
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    ex = task.extract_batch(batch)
    if tuple(ex["rgb"].shape) != (SATCLIP_BATCH, TRAIN_TILE, TRAIN_TILE, 4):
        raise AssertionError(f"concat input {tuple(ex['rgb'].shape)}")
    reset_counts()
    pred, _ = task.eval_step(ex)
    forward = counts()
    with plain_route():
        pred_plain, _ = plain.eval_step(ex)
    db = psnr(pred, pred_plain, 2.0)
    log("concat", f"forward of {tuple(ex['rgb'].shape)}: launches {forward}, "
        f"kernels vs plain route PSNR {db:.2f} dB (bound 40)")
    if (min(forward[k] for k in SERVING_KERNELS) == 0 or not db >= 40.0
            or not bool(torch.isfinite(pred).all())):
        raise AssertionError(f"concat forward: {forward}, {db} dB")
    reset_counts()
    got = loss_terms(task.train_step(task.init_state(), ex))
    torch.cuda.synchronize()
    launched = counts()
    with plain_route():
        ref = loss_terms(plain.train_step(plain.init_state(), ex))
    check_terms(f"concat: bf16 step 1, kernels vs plain route (launches {launched})",
                got, ref, 2e-2, 1e-3)
    if min(launched.values()) == 0:
        raise AssertionError(f"the concat step skipped a kernel: {launched}")
    check_gradients(task)


def phase_nonsquare() -> None:
    """The inject and concat planes of a non-square map (64 x 96) on the
    card, f32 with TF32 off, against the CPU (``ROADMAP.md`` C4).  Both
    routes keep the reference's swapped (W, H) resize, so a whole
    non-square forward fails in both packages; the planes are what the card
    computes at such a map: the inject generator's ``location_plane`` (its
    ``fc``, then the bilinear resize) and the concat route's plane (the
    tiled embedding through ``resize_bicubic``, as ``_concat_embedding_plane``
    calls it), each (2, 96, 64, 1), within 1e-5 of the CPU's largest
    value."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G_inject
    from nirgan_tpu_torch.ops.resize import resize_bicubic

    cfg = load_config(SATCLIP_CONFIG)
    e = torch.randn((2, 256), generator=torch.Generator().manual_seed(SEED))
    planes = {}
    with cudnn_tf32(False), torch.no_grad():
        for d in ("cuda", "cpu"):
            G = define_G_inject(cfg, generator=torch.Generator().manual_seed(SEED)).to(d)
            tiled = e.to(d).reshape(2, 1, 256, 1).expand(2, 256, 256, 1)
            planes[d] = {"inject": G.location_plane(e.to(d), 64, 96).cpu(),
                         "concat": resize_bicubic(tiled, 96, 64).cpu()}
    for name, ref in planes["cpu"].items():
        got = planes["cuda"][name]
        err = float((got - ref).abs().max() / ref.abs().max())
        log("nonsquare", f"{name} plane of a 64 x 96 map, card vs CPU (f32, TF32 "
            f"off): shape {tuple(got.shape)} (the swapped (W, H)), relative {err:.2e} "
            "(bound 1e-5)")
        if tuple(got.shape) != (2, 96, 64, 1) or not err <= 1e-5:
            raise AssertionError(f"{name} plane: {tuple(got.shape)}, {err}")


def phase_param_dtype() -> dict:
    """One fused step of ``config_px2px.yaml`` at full width (batch 16 at
    276^2, bf16 activations) with ``tpu.param_dtype: bfloat16``: G's and
    D's parameters made in bf16, the kernels' launches those of the
    f32-parameter step, finite terms and gradients, the parameters f32
    after the update (the JAX step's ``p + lr u`` with an f32 LR), the same
    step from the same seed bit for bit; the first step's ms (CUDA events,
    three fresh tasks in turns with the f32-parameter config's first step,
    the medians).  The optimizer's update of G's and D's f32 parameters
    alone, warm: ``OptaxAdam`` against ``torch.optim.Adam`` (its foreach
    form, the library call for the same update).  Returns the step's
    launches and times."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train.state import OptaxAdam

    cfgs = {"bfloat16": load_config(CONFIG), "float32": load_config(CONFIG)}
    cfgs["bfloat16"].tpu.param_dtype = "bfloat16"
    batch = first_batch(cfgs["float32"])

    def first_step(name):
        task = Px2PxTask(cfgs[name], device="cuda", seed=SEED)
        ex = task.extract_batch(batch)
        state = task.init_state()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        terms = loss_terms(task.train_step(state, ex))
        end.record()
        end.synchronize()
        return task, terms, start.elapsed_time(end)

    made = {p.dtype for p in Px2PxTask(cfgs["bfloat16"], device="cuda",
                                       seed=SEED).netG.parameters()}
    reset_counts()
    task, terms, _ = first_step("bfloat16")
    per_step = counts()
    no_library("bf16 parameters")
    check_gradients(task)
    after = {p.dtype for net in (task.netG, task.netD) for p in net.parameters()}
    again, repeat, _ = first_step("bfloat16")
    same = repeat == terms and all(
        torch.equal(p, q) for a, b in ((task.netG, again.netG), (task.netD, again.netD))
        for p, q in zip(a.parameters(), b.parameters()))
    finite = all(math.isfinite(v) for v in terms.values())
    log("param_dtype", f"bf16 parameters: made {made}, after the update {after}; "
        f"launches per step {per_step} (want {STEP_LAUNCHES}); terms finite {finite}; "
        f"the step again from the seed bit for bit: {same}")
    if (made != {torch.bfloat16} or after != {torch.float32} or per_step != STEP_LAUNCHES
            or not finite or not same):
        raise AssertionError(f"bf16 parameters: {made}, {after}, {per_step}, {finite}, "
                             f"{same}")
    del task, again
    rounds = [[first_step(name)[2] for name in ("bfloat16", "float32")] for _ in range(3)]
    bf16_ms, f32_ms = np.median(np.asarray(rounds), axis=0)
    log("param_dtype", f"first step, batch {TRAIN_BATCH} at {TRAIN_SIDE}^2 (CUDA events, "
        f"medians of 3 fresh tasks in turns): bf16 parameters {bf16_ms:.3f} ms, f32 "
        f"parameters {f32_ms:.3f} ms; rounds {np.round(rounds, 2).tolist()}")

    task = Px2PxTask(cfgs["float32"], device="cuda", seed=SEED)
    params = [p for net in (task.netG, task.netD) for p in net.parameters()]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device="cuda") * 1e-3
    hyper = dict(lr=float(cfgs["float32"].base_configs.lr), betas=(0.5, 0.999), eps=1e-8)
    adam_ms, torch_adam_ms = compare_ms(OptaxAdam(params, **hyper).step,
                                        torch.optim.Adam(params, foreach=True, **hyper).step)
    log("param_dtype", f"Adam's update of G's and D's {len(params)} f32 parameters "
        f"({sum(p.numel() for p in params)} values), warm (CUDA events and the host "
        f"clock, the larger): OptaxAdam {adam_ms:.3f} ms, torch.optim.Adam (foreach) "
        f"{torch_adam_ms:.3f} ms")
    del task, params
    torch.cuda.empty_cache()
    return {"per_step": per_step, "first_step_ms": float(bf16_ms),
            "f32_first_step_ms": float(f32_ms)}


# ------------------------------------------------------------ scene serving
SCENE_TILE, SCENE_OVERLAP, SCENE_BATCH = 512, 32, 32
S2_SIDE = 10980  # a Sentinel-2 tile at 10 m: 625 windows of 512^2
SCENE_H, SCENE_W = 3000, 4000  # 63 windows: the last row and column clamp
# a UTM grid (EPSG:32633, 10 m): the windows' centres lie tens of km apart
SCENE_GRID = dict(pixel_scale=(10.0, 10.0), origin=(300000.0, 5200020.0), epsg=32633)
# wrapper calls of one window batch, bf16 and int8 (B 5 outside the trunk)
SCENE_BATCH_LAUNCHES = {"trunk_conv": 18, "instance_norm": 23, "head_conv": 1}
SCENE: dict = {}  # what the scene phases measured, for the kernels line


def scene_meta(height: int, width: int) -> dict:
    """``read_geotiff`` metadata of a raster on ``SCENE_GRID``."""
    (sx, sy), (ox, oy) = SCENE_GRID["pixel_scale"], SCENE_GRID["origin"]
    return {"width": width, "height": height, "pixel_scale": (sx, sy),
            "tiepoint": (0.0, 0.0, 0.0, ox, oy, 0.0), "epsg": SCENE_GRID["epsg"]}


def seeded_scene(height: int, width: int, seed: int = SEED) -> np.ndarray:
    """A (3, height, width) uint16 DN scene made in memory from a seed:
    smooth fields (bicubic from a coarse grid) plus noise, in the range of
    Sentinel-2 reflectance DN."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, height // 64 + 2, width // 64 + 2),
                                         dtype=np.float32))
    field = torch.nn.functional.interpolate(coarse, size=(height, width),
                                            mode="bilinear", align_corners=False)[0]
    noise = rng.integers(0, 400, (3, height, width), dtype=np.uint16)
    return (field.numpy() * 2600).astype(np.uint16) + noise


def scene_windows(height: int, width: int) -> int:
    """The windows of a scene on the serving grid."""
    from nirgan_tpu_torch.inference.scene import _scene_pads, tile_origins

    (top, bottom), (left, right) = _scene_pads(height, width, SCENE_TILE, SCENE_OVERLAP)
    stride = SCENE_TILE - 2 * SCENE_OVERLAP
    return (len(tile_origins(height + top + bottom, SCENE_TILE, stride))
            * len(tile_origins(width + left + right, SCENE_TILE, stride)))


def scene_runs(n_windows: int) -> int:
    return -(-n_windows // SCENE_BATCH)


def scene_counts(n_batches: int, int8: bool = False, calibrated: bool = False) -> dict:
    """The wrapper calls a scene of ``n_batches`` window batches should
    make: bf16, or the int8 trunk (D 18 / E 19 a batch, B the 5 outside the
    trunk) after one calibrating float forward of the first batch."""
    want = {name: 0 for name in (*kernels(), *int8_kernels())}
    if int8:
        want.update(int8_conv=18 * n_batches, int8_norm=19 * n_batches,
                    instance_norm=5 * n_batches, head_conv=n_batches)
        if calibrated:
            for name, n in SCENE_BATCH_LAUNCHES.items():
                want[name] += n
    else:
        want.update({name: n * n_batches for name, n in SCENE_BATCH_LAUNCHES.items()})
    return want


def timed_run(fn):
    """(fn(), ms from CUDA events around it)."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    out = fn()
    marks[1].record()
    marks[1].synchronize()
    return out, marks[0].elapsed_time(marks[1])


def all_counts() -> dict:
    return {**counts(), **int8_counts()}


def check_scene_counts(tag: str, want: dict) -> dict:
    got = all_counts()
    no_library(tag)
    log(tag, f"wrapper calls {got}")
    if got != want:
        raise AssertionError(f"{tag}: wrapper calls {got}, want {want}")
    return got


def phase_scene() -> None:
    """Whole-scene serving through ``inference/scene.py`` on
    ``config_px2px.yaml`` (bf16, seed 0, 512^2 windows at overlap 32, batch
    32): (b) a 3000 x 4000 scene against the plain route and again bit for
    bit; (a) a Sentinel-2-sized 10980^2 scene, windows/s by CUDA events,
    peak memory, wrapper calls; (c) the 3000 x 4000 scene with the int8
    trunk against D and E's plain versions and against bf16, bit for bit
    twice; (d) the inject route of ``config_px2px_SatCLIP.yaml`` with
    per-window coordinates; (e) f32, two windows, card against CPU."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference.scene import blend_scene, synthesize_scene, upload_scene
    from nirgan_tpu_torch.tasks import Px2PxTask

    kw = dict(tile=SCENE_TILE, overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH)
    task = Px2PxTask(load_config(CONFIG), seed=SEED)
    if task.device.type != "cuda":
        raise AssertionError(f"Px2PxTask serves on {task.device} by default")

    # --- (b) 3000 x 4000: kernels against the plain route, bit for bit twice
    x = seeded_scene(SCENE_H, SCENE_W)
    meta = scene_meta(SCENE_H, SCENE_W)
    n_wins = scene_windows(SCENE_H, SCENE_W)
    n_b = scene_runs(n_wins)
    reset_counts()
    y = synthesize_scene(task, x, meta=meta, **kw)
    torch.cuda.synchronize()
    check_scene_counts("scene 3000x4000", scene_counts(n_b))
    again, ms_bf16 = timed_run(lambda: synthesize_scene(task, x, meta=meta, **kw))
    with plain_route():
        y_plain = synthesize_scene(task, x, meta=meta, **kw)
    db = psnr(torch.from_numpy(y), torch.from_numpy(y_plain), 2.0)
    same = np.array_equal(y, again)
    log("scene 3000x4000", f"{n_wins} windows in {n_b} batches: {y.shape}, kernels vs plain "
        f"route {db:.2f} dB (bound 40), a second run bit for bit: {same}; the scene "
        f"in {ms_bf16:.1f} ms (CUDA events, the copies in and out included)")
    if y.shape != (1, SCENE_H, SCENE_W) or not np.isfinite(y).all() or not db >= 40.0 \
            or not same:
        raise AssertionError(f"scene 3000x4000: {y.shape}, {db} dB, {same}")

    # --- (c) the int8 trunk on the same scene
    cfg8 = load_config(CONFIG)
    cfg8.tpu.serving_quant = "int8"
    task8 = Px2PxTask(cfg8, seed=SEED)
    reset_counts()
    y8 = synthesize_scene(task8, x, meta=meta, **kw)
    torch.cuda.synchronize()
    SCENE["int8"] = check_scene_counts("scene int8", scene_counts(n_b, int8=True,
                                                                  calibrated=True))
    y8_again, ms_int8 = timed_run(lambda: synthesize_scene(task8, x, meta=meta, **kw))
    same8 = np.array_equal(y8, y8_again)
    with int8_plain_route():
        y8_de_plain = synthesize_scene(task8, x, meta=meta, **kw)
    with plain_route():
        y8_all_plain = synthesize_scene(task8, x, meta=meta, **kw)
    t = torch.from_numpy
    db_plain, db_float = psnr(t(y8), t(y8_de_plain), 2.0), psnr(t(y8), t(y), 2.0)
    own = psnr(t(y8_all_plain), t(y_plain), 2.0)
    # the bound of the int8 serving phase: the method's own error, which
    # the kernels may not add to; against D and E's plain versions only a
    # floor, since their moments, summed in another order, move a few int8
    # values a step and each passes on through the blocks (measured 38.81
    # dB at batch 32 where the batch-4 forward reads 40.5; a wrong scale or
    # weight reads under 20)
    log("scene int8", f"vs D and E's plain versions {db_plain:.2f} dB (floor 35), vs "
        f"the bf16 scene {db_float:.2f} dB (bound: >= 33 and within 1 dB of the plain "
        f"versions' own {own:.2f}), a second run bit for bit: {same8}; the scene in "
        f"{ms_int8:.1f} ms against bf16's {ms_bf16:.1f} (CUDA events)")
    if not (db_plain >= 35.0 and db_float >= max(33.0, own - 1.0) and same8):
        raise AssertionError(f"scene int8: {db_plain}, {db_float} ({own}), {same8}")
    del task8

    # --- (d) inject, one embedding a window from the scene's UTM grid
    cfg_i = load_config(SATCLIP_CONFIG)
    task_i = Px2PxTask(cfg_i, seed=SEED)
    with torch.no_grad():  # 0.5, not the config's 0.01: a fault would show
        task_i.netG.scale_param.fill_(0.5)
    embeds = []
    embed = task_i._embed
    task_i._embed = lambda coords: embeds.append(embed(coords)) or embeds[-1]
    reset_counts()
    y_i = synthesize_scene(task_i, x, meta=meta, **kw)
    torch.cuda.synchronize()
    check_scene_counts("scene inject", scene_counts(n_b))
    with plain_route():
        y_i_plain = synthesize_scene(task_i, x, meta=meta, **kw)
    db_i = psnr(t(y_i), t(y_i_plain), 2.0)
    e = torch.cat(embeds[:n_b])
    apart = float((e[0] - e[-1]).abs().max())
    log("scene inject", f"{len(e)} window embeddings of {tuple(e.shape[1:])}; the "
        f"first and the last window's differ by max|diff| {apart:.3e}; kernels vs "
        f"plain route {db_i:.2f} dB (bound 40)")
    if len(e) != n_wins or not apart > 0.0 or not db_i >= 40.0:
        raise AssertionError(f"scene inject: {len(e)} embeddings, {apart}, {db_i} dB")
    del task_i

    # --- (e) f32 on the card (TF32 off) against the CPU: two windows
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = load_config(CONFIG)
    cfg32.tpu.compute_dtype = "float32"
    # a window's plateau high and two wide: two windows, 448 x 896
    side = SCENE_TILE - 2 * SCENE_OVERLAP
    small = seeded_scene(side, 2 * side, seed=1)
    on_card = synthesize_scene(Px2PxTask(cfg32, seed=SEED), small, **kw)
    on_cpu = synthesize_scene(Px2PxTask(cfg32, device="cpu", seed=SEED), small, **kw)
    err = float(np.abs(on_card - on_cpu).max())
    log("scene f32", f"{side}x{2 * side} ({scene_windows(side, 2 * side)} windows), "
        f"card vs CPU: max|err| {err:.3e} (bound 1e-03)")
    if scene_windows(side, 2 * side) != 2 or not err <= 1e-3:
        raise AssertionError(f"scene f32 card vs CPU: {err}")

    # --- (a) the Sentinel-2-sized scene
    big = seeded_scene(S2_SIDE, S2_SIDE, seed=2)
    n_a = scene_windows(S2_SIDE, S2_SIDE)
    del y_plain, y8_de_plain, y8_all_plain, y_i_plain
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    marks[0].record()
    padded = upload_scene(task, big, SCENE_TILE, SCENE_OVERLAP)
    marks[1].record()
    nir, _ = blend_scene(task, padded, S2_SIDE, S2_SIDE, meta=scene_meta(S2_SIDE, S2_SIDE),
                         **kw)
    t_queued = time.perf_counter()
    marks[2].record()
    out = nir.cpu().numpy()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del padded, nir
    SCENE["big"] = big
    SCENE["bf16"] = check_scene_counts("scene 10980^2", scene_counts(scene_runs(n_a)))
    upload_ms, windows_ms = marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
    SCENE.update(windows_ms=windows_ms, windows=n_a, wall_s=wall,
                 queued_s=t_queued - t0, peak_gb=peak / 2**30, upload_ms=upload_ms)
    log("scene 10980^2", f"{n_a} windows in {scene_runs(n_a)} batches of "
        f"{SCENE_BATCH}: upload and pad {upload_ms:.1f} ms, windows {windows_ms:.1f} ms "
        f"(CUDA events) = {n_a / windows_ms * 1e3:.1f} windows/s; wall {wall:.3f} s "
        f"(host clock, the final copy included), the host done queueing the work after "
        f"{t_queued - t0:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
    if out.shape != (1, S2_SIDE, S2_SIDE) or not np.isfinite(out).all():
        raise AssertionError(f"scene 10980^2: {out.shape}")


WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (host and device): (the
    ``key_averages``, the runtime calls by which the host waits for the
    card, by name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    table = prof.key_averages()
    return table, {ev.key: ev.count for ev in table if ev.key in WAIT_CALLS}


def host_waits(fn, then_sync: bool = False) -> dict:
    """The waits for the card that one call of ``fn`` makes (runtime calls
    by name), beyond those of a window that runs nothing (the profiler's
    own) or, with ``then_sync``, only ``torch.cuda.synchronize``."""
    def window(f):
        return lambda: (f(), torch.cuda.synchronize() if then_sync else None)

    _, base = profiled(window(lambda: None))
    _, got = profiled(window(fn))
    return {k: n - base.get(k, 0) for k, n in got.items() if n - base.get(k, 0)}


def phase_host_waits() -> None:
    """Under ``torch.profiler`` (last: an attached profiler slows the host's
    later launches): the 10980^2 scene's window loop again, its device busy
    time against the span ``phase_scene`` read without the profiler, so the
    share of that span the card sat idle waiting for the host, and the host's
    waits on the card in the loop (none may happen); and the waits of one
    ``extract_batch`` of the train batch (none) and of one bare step."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference.scene import blend_scene, upload_scene
    from nirgan_tpu_torch.tasks import Px2PxTask

    task = Px2PxTask(load_config(CONFIG), seed=SEED)
    padded = upload_scene(task, SCENE.pop("big"), SCENE_TILE, SCENE_OVERLAP)
    torch.cuda.synchronize()

    def loop() -> float:
        """Device busy ms of the window loop."""
        table, _ = profiled(lambda: (blend_scene(
            task, padded, S2_SIDE, S2_SIDE, meta=scene_meta(S2_SIDE, S2_SIDE),
            tile=SCENE_TILE, overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH),
            torch.cuda.synchronize()))
        return sum(ev.device_time_total for ev in table
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.is_user_annotation) / 1e3

    busy = loop()
    waits = host_waits(lambda: blend_scene(
        task, padded, S2_SIDE, S2_SIDE, meta=scene_meta(S2_SIDE, S2_SIDE),
        tile=SCENE_TILE, overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH), then_sync=True)
    # the same loop with a generator that only takes the input's first
    # channel: what the cut (slices, stack, DN scaling) and the blend cost
    task.g_apply = lambda x, embeds=None, trunk_q=None: x[..., :1]
    cut_blend = loop()
    del task.g_apply
    idle = 1.0 - busy / SCENE["windows_ms"]
    SCENE.update(busy_ms=busy, idle_share=idle, cut_blend_ms=cut_blend)
    log("host waits", f"scene 10980^2: device busy {busy:.1f} ms (under the "
        f"profiler) against the {SCENE['windows_ms']:.1f} ms window span read "
        f"without it: the card idle {idle * 100:.1f}% of the span; the host's waits "
        f"on the card in the loop {waits}; cut and blend alone {cut_blend:.1f} ms "
        f"busy ({cut_blend / busy * 100:.1f}% of the loop)")
    del padded
    batch = first_batch(load_config(CONFIG))
    state = task.init_state()
    task.train_step(state, task.extract_batch(batch))
    torch.cuda.synchronize()
    in_extract = host_waits(lambda: task.extract_batch(batch))
    ex = task.extract_batch(batch)
    in_step = host_waits(lambda: task.train_step(state, ex))
    log("host waits", f"one extract_batch of the train batch: {in_extract}; one "
        f"bare train step: {in_step} (runtime calls beyond an empty window's)")
    if waits or in_extract:
        raise AssertionError(f"the host waited for the card: scene loop {waits}, "
                             f"extract_batch {in_extract}")


def phase_scene_cli(tmp: str) -> None:
    """``python -m nirgan_tpu_torch.synthesize_scene`` (its ``main``, in this
    process, to read its launches) on a written 3000 x 4000 deflate
    GeoTIFF with ``--quant int8`` and ``--match-histogram``, on the card by
    default: the output's grid round-trips, its values equal the
    in-process scene followed by ``histogram_match``, and the run prints
    its wall time split."""
    import io

    from nirgan_tpu_torch import synthesize_scene as cli
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data.geotiff import read_geotiff, write_geotiff
    from nirgan_tpu_torch.inference import histogram_match, synthesize_scene
    from nirgan_tpu_torch.tasks import Px2PxTask

    x = seeded_scene(SCENE_H, SCENE_W, seed=3)
    ref = seeded_scene(SCENE_H // 2, SCENE_W // 2, seed=4)[2:3]
    src, refp, dst = (os.path.join(tmp, f) for f in ("rgb.tif", "ref.tif", "nir.tif"))
    write_geotiff(src, x, compression="deflate", **SCENE_GRID)
    write_geotiff(refp, ref, compression="deflate", **SCENE_GRID)
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed):
        cli.main([src, dst, "--config", CONFIG, "--quant", "int8", "--tile",
                  str(SCENE_TILE), "--overlap", str(SCENE_OVERLAP), "--batch-size",
                  str(SCENE_BATCH), "--match-histogram", refp])
    torch.cuda.synchronize()
    print(printed.getvalue().replace("\r", "\n").strip().splitlines()[-1], flush=True)
    check_scene_counts("scene CLI", scene_counts(scene_runs(scene_windows(
        SCENE_H, SCENE_W)), int8=True, calibrated=True))
    nir, meta = read_geotiff(dst)
    cfg8 = load_config(CONFIG)
    cfg8.tpu.serving_quant = "int8"
    own = synthesize_scene(Px2PxTask(cfg8, seed=SEED), x, tile=SCENE_TILE,
                           overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH,
                           meta=scene_meta(SCENE_H, SCENE_W))
    ref_dev = torch.from_numpy(ref.astype(np.float32) / 10000.0).cuda()
    want = histogram_match(torch.from_numpy(own).cuda()[..., None],
                           ref_dev[..., None])[..., 0].cpu().numpy()
    grid = (meta.get("epsg"), tuple(meta["pixel_scale"][:2]), tuple(meta["tiepoint"][3:5]))
    want_grid = (SCENE_GRID["epsg"], SCENE_GRID["pixel_scale"], SCENE_GRID["origin"])
    split = printed.getvalue().strip().splitlines()[-1]
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "nirgan_tpu"))
    log("scene CLI", f"{nir.shape} on {grid}; equal to the in-process scene + "
        f"histogram_match: {np.array_equal(nir, want)} (max|diff| "
        f"{float(np.abs(nir - want).max()):.3e}); jax or the JAX package loaded: "
        f"{jax_loaded}")
    if (nir.shape != (1, SCENE_H, SCENE_W) or grid != want_grid
            or not np.array_equal(nir, want) or jax_loaded
            or not all(w in split for w in ("read", "upload", "windows", "histogram",
                                            "write"))):
        raise AssertionError(f"scene CLI: {nir.shape}, {grid}, {split!r}, {jax_loaded}")


# the auxiliary losses' lambdas for the smoke's step, and the index weights:
# EVI and MSAVI, whose denominators stay away from zero.  NDVI's, NDWI's and
# SAVI's (prediction + R, G or R + 0.5) and GNDVI's (NDVI + G) pass through
# zero where the seeded generator's tanh output is about -R, and there the
# routes' bf16 differences grow without bound (tests/test_torch_aux_losses.py
# holds all six on fixed inputs)
AUX_LAMBDAS = {"lambda_ssim": 1.0, "lambda_hist": 10.0, "lambda_rs_losses": 1.0}
AUX_RS_WEIGHTS = {"lambda_ndvi": 0.0, "lambda_ndwi": 0.0, "lambda_gndvi": 0.0,
                  "lambda_savi": 0.0, "lambda_msavi": 0.4, "lambda_evi": 0.6}


def model_terms(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items() if k.startswith("model_loss/")}


def phase_aux_step() -> None:
    """One fused step of the flagship ``config_px2px_SatCLIP.yaml`` (batch 8
    at 276^2) with the three auxiliary losses on: the 8 + 3 loss terms
    within 2% + 1e-3 of the plain route, every parameter with a gradient,
    launches a step as without them; the step timed with and without the
    terms, and ``emd_loss`` (a softmax and a cumulative sum over each
    image's 65,536 pixels) timed on its own, forward and backward."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.losses import emd_loss
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = load_config(SATCLIP_CONFIG)
    for key, value in AUX_LAMBDAS.items():
        cfg.base_configs[key] = value
    cfg.base_configs.internal_rs_loss_weights = dict(AUX_RS_WEIGHTS)
    batch = first_batch(cfg)
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    ex = task.extract_batch(batch)
    reset_counts()
    got = model_terms(task.train_step(task.init_state(), ex))
    torch.cuda.synchronize()
    per_step = counts()
    no_library("aux step")
    if per_step != STEP_LAUNCHES or len(got) != 11:
        raise AssertionError(f"aux step: launches {per_step}, terms {sorted(got)}")
    check_gradients(task)
    with plain_route():
        ref = model_terms(plain.train_step(plain.init_state(), ex))
    check_terms("flagship step with SSIM, EMD and the indices, kernels vs plain "
                "route", got, ref, 2e-2, 1e-3)
    base = Px2PxTask(load_config(SATCLIP_CONFIG), device="cuda", seed=SEED)
    state, base_state = task.init_state(), base.init_state()
    ms, base_ms = compare_ms(lambda: task.train_step(state, ex),
                             lambda: base.train_step(base_state, ex), iters=5)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (SATCLIP_BATCH, TRAIN_TILE, TRAIN_TILE, 1)
    pred = torch.randn(shape, device="cuda", generator=g).bfloat16().requires_grad_(True)
    nir = torch.rand(shape, device="cuda", generator=g)
    fwd_ms = time_ms(lambda: emd_loss(pred, nir), iters=20, run_ahead=True)
    both_ms = time_ms(lambda: emd_loss(pred, nir).backward(), iters=20)
    log("aux", f"flagship step (batch {SATCLIP_BATCH}) with the auxiliary losses "
        f"{ms:.3f} ms, without {base_ms:.3f} ms; emd_loss on {shape}: forward "
        f"{fwd_ms:.4f} ms, forward + backward {both_ms:.4f} ms (torch ops)")


def phase_ngf16() -> None:
    """``config_px2px.yaml`` at ngf 16 and ndf 16, widths kernels A and C
    are not built for: serving (``predict_step`` on 4 tiles of 512^2) and
    one fused step (batch 16 at 276^2) take the library routes of the trunk
    conv and the head, the instance norms and the transposed convs' backward
    their kernels; each against the plain route."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = load_config(CONFIG)
    cfg.base_configs.ngf, cfg.base_configs.ndf = 16, 16
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    rgb = np.random.default_rng(3).random((BATCH, 3, TILE, TILE), np.float32) * 0.3
    reset_counts()
    y = task.predict_step(rgb)
    torch.cuda.synchronize()
    serve, libs = counts(), library_counts()
    with plain_route():
        y_plain = plain.predict_step(rgb)
    db = psnr(torch.from_numpy(y), torch.from_numpy(y_plain), 2.0)
    log("ngf16", f"predict_step {rgb.shape}: kernels {serve}, library routes {libs}; "
        f"vs the plain route {db:.2f} dB (bound 40)")
    want = {"trunk_conv_library": 18, "head_conv_library": 1}
    if (libs != want or serve["trunk_conv"] or serve["head_conv"]
            or serve["instance_norm"] != EVAL_LAUNCHES["instance_norm"]
            or not db >= 40.0 or not np.isfinite(y).all()):
        raise AssertionError(f"ngf 16 serving: {serve}, {libs}, {db}")
    batch = first_batch(cfg)
    ex = task.extract_batch(batch)
    reset_counts()
    got = model_terms(task.train_step(task.init_state(), ex))
    torch.cuda.synchronize()
    step, libs, pads = counts(), library_counts(), pad_counts()
    log("ngf16", f"step: kernels {step}, library routes {libs}, the trunk backward's "
        f"pads (64 channels) {pads}")
    if (libs != want or step["trunk_conv"] or step["head_conv"]
            or step["convt_bwd"] != 2 or step["instance_norm_bwd"] != 32
            or pads != PAD_STEP_LAUNCHES):
        raise AssertionError(f"ngf 16 step: {step}, {libs}, {pads}")
    check_gradients(task)
    with plain_route():
        ref = model_terms(plain.train_step(plain.init_state(), ex))
    check_terms("ngf 16 step, kernels and library routes vs plain route", got, ref,
                2e-2, 1e-3)


# ------------------------------------------------------------ model variants
BASELINE_CONFIG = os.path.join(ROOT, "configs", "config_baselines.yaml")
BASELINE_MODELS = ("Linear_NIR", "MLP_NIR", "CNN_NIR")
# the U-Net serves unpadded tiles (a 512^2 tile divides by 2^8)
UNET_TILE = TILE
# wrapper calls of one unet_256 forward (6 norms on the way down, 7 on the
# way up, kernel B without the ReLU) and of one fused step (G's 13 and the
# PatchGAN's 3 in each of D's three forwards; the backward of G's 13, of
# D's 6 for the D loss and of its 3 for the G loss)
UNET_FORWARD = {"trunk_conv": 0, "instance_norm": 13, "instance_norm_bwd": 0,
                "head_conv": 0, "convt_bwd": 0}
UNET_STEP = {"trunk_conv": 0, "instance_norm": 22, "instance_norm_bwd": 22,
             "head_conv": 0, "convt_bwd": 0}
# and of unet_128's (one level fewer: 5 norms down, 6 up; G's 11 and D's 9
# in the step)
UNET128_FORWARD = {**UNET_FORWARD, "instance_norm": 11}
UNET128_STEP = {**UNET_STEP, "instance_norm": 20, "instance_norm_bwd": 20}
UNET_CALLS = {"unet_256": (UNET_FORWARD, UNET_STEP), "unet_128": (UNET128_FORWARD, UNET128_STEP)}
# the kernels' wrapper calls on the new paths, for the kernels line
VARIANTS: dict = {}


def unet_config(**overrides):
    """``config_px2px.yaml`` with ``unet_256``, unpadded (``Data.padding:
    false``: the U-Net's sides must divide by 2^8), made in memory, and any
    other ``base_configs`` values given."""
    from nirgan_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.base_configs.netG = "unet_256"
    cfg.Data.padding = False
    for key, value in overrides.items():
        cfg.base_configs[key] = value
    return cfg


def unet_norm_shapes(netg: str = "unet_256") -> list:
    """The shapes of the U-Net step's instance norms at batch 16 of 256^2,
    one a level from 1 to num_downs - 1: 128^2 x 64 (the last way up) down
    to 2^2 x 512 (unet_256's innermost; unet_128's is 4^2 x 512)."""
    n, s = TRAIN_BATCH, TRAIN_TILE
    return [(n, s >> level, s >> level, 64 * min(1 << (level - 1), 8))
            for level in range(1, {"unet_256": 8, "unet_128": 7}[netg])]


def check_tiny_slab_plans(g: torch.Generator) -> None:
    """B and B4 in f32 at the U-Net's 2^2 and 4^2 x 512 shapes under every
    resident plan the kernels take (clusters of 1 up to one pixel a rank)
    and the streaming one, against their plain versions within the
    few-pixel bounds: ``launch_plan`` picks one block a slab there, so the
    split of a tiny slab over a cluster's ranks runs only here."""
    from nirgan_tpu_torch.ops.instance_norm import (
        _launch,
        _launch_bwd,
        instance_norm_bwd_plain,
        instance_norm_plain,
        resident_plans,
        streaming_plan,
    )

    for shape in ((TRAIN_BATCH, 2, 2, 512), (TRAIN_BATCH, 4, 4, 512)):
        b, h, w, c = shape
        x = torch.randn(shape, device="cuda", generator=g) * 3.0 + 1.5
        dy = torch.randn(shape, device="cuda", generator=g)
        ref, stats = instance_norm_plain(x, return_stats=True)
        ref_dx = instance_norm_bwd_plain(x, dy, stats)
        fwd_bound = few_pixel_f32_bound(x)
        bwd_bound = few_pixel_f32_bwd_bound(x, dy, stats)
        for backward in (False, True):
            plans = resident_plans(h * w, c, 4, backward) + [streaming_plan(b, h * w, c, 4)]
            worst = []
            for plan in plans:
                if backward:
                    err = (_launch_bwd(x, dy, stats, False, plan=plan) - ref_dx).abs()
                    rel = float((err / bwd_bound).max())
                else:
                    err = (_launch(x, 1e-5, False, None, plan=plan)[0] - ref).abs()
                    rel = float((err / fwd_bound).max())
                worst.append((plan.regime, plan.cluster, round(rel, 3)))
                if not rel <= 1.0:
                    raise AssertionError(f"{'B4' if backward else 'B'} {shape} under "
                                         f"{plan}: |err| / bound {rel}")
            log("unet", f"{'B4' if backward else 'B'} f32 {shape} under every plan "
                f"(regime, cluster, worst |err| / few-pixel bound): {worst}")


def phase_unet_norms(g: torch.Generator) -> None:
    """B and B4 against their plain versions at unet_256's seven norm
    shapes, without the ReLU (the U-Net fuses none), f32 and bf16, each timed
    with its bound and its library call; the entries go under
    ``unet_shapes``, and those of unet_128's six (unet_256's first six) under
    ``unet_128_shapes``."""
    dev = torch.device("cuda")
    fwd_all, bwd_all, worst, worst_bwd = [], [], 0.0, 0.0
    for shape in unet_norm_shapes():
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        dy = torch.randn(shape, device=dev, generator=g)
        # a 2^2 ... 8^2 image's statistics: the few-pixel f32 bound
        few = shape[1] * shape[2] <= 64
        worst = max(worst, check_norm(x, False, few_pixels=few))
        worst_bwd = max(worst_bwd, check_norm_bwd(x, dy, False, few_pixels=few))
        xb, gb = x.bfloat16(), dy.bfloat16()
        fwd_all.append(times(shape, *norm_times(xb, False)))
        bwd_all.append(times(shape, *bwd_times(xb, gb, False)))
    check_tiny_slab_plans(g)
    RESULTS["instance_norm"]["unet_shapes"] = fwd_all
    RESULTS["instance_norm_bwd"]["unet_shapes"] = bwd_all
    unet128 = [str(shape) for shape in unet_norm_shapes("unet_128")]
    for name, entries in (("instance_norm", fwd_all), ("instance_norm_bwd", bwd_all)):
        RESULTS[name]["unet_128_shapes"] = [e for e in entries if e["shape"] in unet128]
    for name, err in (("instance_norm", worst), ("instance_norm_bwd", worst_bwd)):
        RESULTS[name]["max_abs_err"] = max(RESULTS[name]["max_abs_err"], err)
    shares = [e["bound_ms"] / e["ms"] for e in fwd_all + bwd_all]
    log("unet", f"B and B4 at the U-Net's norm shapes: share of the bound "
        f"{min(shares) * 100:.1f}-{max(shares) * 100:.1f}%")
    if max(shares) > 1.0:
        raise AssertionError(f"a kernel under its bound: {fwd_all + bwd_all}")


def buffers_of(task) -> dict:
    """Every buffer (the batch norms' running statistics) of both
    networks, copied."""
    return {f"{tag}.{k}": b.detach().clone()
            for tag, net in (("G", task.netG), ("D", task.netD))
            for k, b in net.named_buffers()}


def grads_and_stats(task) -> dict:
    """Every gradient and every running statistic of both networks, copied."""
    return {**{f"{tag}.{k}.grad": p.grad.detach().clone()
               for tag, net in (("G", task.netG), ("D", task.netD))
               for k, p in net.named_parameters()}, **buffers_of(task)}


def check_repeat(what: str, cfg, ex: dict, got: dict, seen: dict, netg=None) -> None:
    """Step 1 of a new task from the same seed (and the same dropout
    generator state) on the same batch: terms, gradients and running
    statistics bit for bit.  ``netg`` makes the new task's generator."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    again = Px2PxTask(cfg, device="cuda", seed=SEED)
    if netg is not None:
        again.netG = netg(again)
    repeat = loss_terms(again.train_step(again.init_state(), ex))
    now = grads_and_stats(again)
    differ = [k for k, v in seen.items() if not torch.equal(v, now[k])]
    log(what, f"the step again from the same seed: {len(differ)} of {len(seen)} "
        f"gradients and statistics differ, terms equal: {repeat == got}")
    if differ or repeat != got:
        raise AssertionError(f"{what}: the step did not repeat: {differ[:8]}, "
                             f"{repeat} vs {got}")


def phase_unet(netg: str = "unet_256") -> dict:
    """The U-Net ``netg`` (``unet_256`` or ``unet_128``) at full width (ngf
    64, ndf 64, basic D, instance norm, bf16 over f32 params): the serving
    forward of 4 x 512^2 on the kernels against the plain route (>= 40 dB),
    bit for bit twice, B's calls (13; 11), timed; ``predict_step`` in f32 on the card (TF32 off) against the CPU on
    2 x 256^2 (<= 1e-3); one fused step at batch 16 of 256^2 (launches,
    every gradient, within 2% + 1e-3 of the plain route, bit for bit from
    the same seed), timed.  Returns the wrapper calls of the forward and
    of the step."""
    from nirgan_tpu_torch.models import define_G
    from nirgan_tpu_torch.tasks import Px2PxTask

    dev = torch.device("cuda")
    seeded = torch.Generator().manual_seed(SEED)
    want_forward, want_step = UNET_CALLS[netg]
    G = define_G(3, 1, 64, netg, "instance", compute_dtype=torch.bfloat16,
                 generator=seeded).to(dev).eval()
    x = (torch.rand((BATCH, UNET_TILE, UNET_TILE, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
    with torch.inference_mode():
        reset_counts()
        y = G(x)
        torch.cuda.synchronize()
        per_forward = counts()
        no_library(f"{netg} forward")
        again = G(x)
        with plain_route():
            y_plain = G(x)
        db = psnr(y, y_plain, 2.0)
        log("unet", f"{netg} forward of {tuple(x.shape)}: launches {per_forward} (want "
            f"{want_forward}); kernels vs plain route PSNR {db:.2f} dB (bound 40), "
            f"max|err| {float((y.float() - y_plain.float()).abs().max()):.3e}; "
            f"again bit for bit: {torch.equal(y, again)}")
        if (per_forward != want_forward or tuple(y.shape) != (BATCH, UNET_TILE, UNET_TILE, 1)
                or not bool(torch.isfinite(y).all()) or not db >= 40.0
                or not torch.equal(y, again)):
            raise AssertionError(f"{netg} forward: {per_forward}, {db} dB")

        def plain_forward():
            with plain_route():
                return G(x)

        ms, plain_ms = compare_ms(lambda: G(x), plain_forward, iters=10)
        log("unet", f"{netg} bf16 forward of {BATCH} x {UNET_TILE}^2: kernels {ms:.3f} ms "
            f"({BATCH / ms * 1e3:.2f} tiles/s), plain {plain_ms:.3f} ms")
    del G, x, y, again, y_plain

    # f32 on the card (kernels, TF32 off) against the same seeded task on
    # the CPU (plain versions)
    cfg = unet_config(netG=netg)
    cfg.tpu.compute_dtype = "float32"
    rgb = np.random.default_rng(2).random((2, 3, TRAIN_TILE, TRAIN_TILE),
                                          dtype=np.float32) * 0.3
    reset_counts()
    with cudnn_tf32(False):  # set here, not inherited from an earlier phase
        got = Px2PxTask(cfg, device="cuda", seed=SEED).predict_step(rgb)
    on_card = counts()
    ref = Px2PxTask(cfg, device="cpu", seed=SEED).predict_step(rgb)
    err = float(np.abs(got - ref).max())
    log("unet", f"{netg} predict_step f32 {rgb.shape}, card vs CPU: max|err| {err:.3e} "
        f"(bound 1e-03), launches {on_card}")
    if got.shape != (2, 1, TRAIN_TILE, TRAIN_TILE) or not err <= 1e-3 \
            or on_card != want_forward:
        raise AssertionError(f"{netg} predict_step card vs CPU: {got.shape}, {err}, "
                             f"{on_card}")

    # --- one fused step at batch 16 of 256^2, kernels vs plain route
    cfg = unet_config(netG=netg)
    batch = first_batch(cfg)
    if batch["rgb"].shape != (TRAIN_BATCH, 3, TRAIN_TILE, TRAIN_TILE):
        raise AssertionError(f"{netg} train batch {batch['rgb'].shape}")
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    state, plain_state = task.init_state(), plain.init_state()
    ex = task.extract_batch(batch)
    reset_counts()
    got = loss_terms(task.train_step(state, ex))
    torch.cuda.synchronize()
    per_step = counts()
    no_library(f"{netg} step")
    log("unet", f"{netg} launches per step {per_step} (want {want_step})")
    if per_step != want_step:
        raise AssertionError(f"{netg} step launches {per_step} != {want_step}")
    check_gradients(task)
    check_repeat(netg, cfg, ex, got, grads_and_stats(task))
    with plain_route():
        ref = loss_terms(plain.train_step(plain_state, ex))
    check_terms(f"{netg}: bf16 step 1, kernels vs plain route", got, ref, 2e-2, 1e-3)

    def plain_step():
        with plain_route():
            plain.train_step(plain_state, ex)

    ms, plain_ms = compare_ms(lambda: task.train_step(state, ex), plain_step, iters=5)
    log("unet", f"{netg} bf16 fused step, batch {TRAIN_BATCH} at {TRAIN_TILE}^2: kernels "
        f"{ms:.3f} ms ({TRAIN_BATCH / ms * 1e3:.2f} images/s), plain {plain_ms:.3f} ms")
    return {"per_forward": per_forward, "per_step": per_step}


def phase_pix2pix() -> None:
    """Upstream pix2pix's defaults on the repo's batch: ``unet_256`` with
    batch norm, ``no_dropout: false`` (the U-Net of the JAX package, which
    the port keeps, has no layer that drops out), the vanilla GAN loss, the
    basic D, lambda_L1 100, batch 16 of 256^2, bf16.  Two steps: terms
    finite, every gradient, the running statistics moved (G's once a step,
    D's three times) and finite; step 1 again from the same seed bit for
    bit; the serving forward in eval mode twice bit for bit.  No kernel of
    the port's is on this path (batch norm and the k4 convs are PyTorch's)."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = unet_config(norm="batch", no_dropout=False, gan_mode="vanilla")
    bc = cfg.base_configs
    if (bc.netD, float(bc.lambda_L1)) != ("basic", 100.0):
        raise AssertionError(f"pix2pix config: {bc.netD}, {bc.lambda_L1}")
    batch = first_batch(cfg)
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    state = task.init_state()
    ex = task.extract_batch(batch)
    start = buffers_of(task)
    reset_counts()
    got = loss_terms(task.train_step(state, ex))
    first = grads_and_stats(task)
    second = loss_terms(task.train_step(state, ex))
    torch.cuda.synchronize()
    launched = counts()
    check_gradients(task)
    now = buffers_of(task)
    moved = [k for k in start if "running" in k and not torch.equal(start[k], now[k])]
    finite = all(bool(torch.isfinite(v).all()) for v in now.values())
    tracked = (int(task.netG.unet.sub.downnorm.num_batches_tracked),
               int(task.netD.norm1.num_batches_tracked))
    n_running = sum(1 for k in start if "running" in k)
    log("pix2pix", f"two steps: terms {got} then {second}; {len(moved)} of "
        f"{n_running} running statistics moved, all finite: {finite}; "
        f"num_batches_tracked G {tracked[0]}, D {tracked[1]}; kernel calls {launched}")
    if (len(moved) != n_running or not finite or tracked != (2, 6)
            or not all(math.isfinite(v) for v in {**got, **second}.values())
            or any(launched.values())):
        raise AssertionError(f"pix2pix steps: {moved}, {finite}, {tracked}, {launched}")
    check_repeat("pix2pix", cfg, ex, got, first)
    rgb = np.random.default_rng(4).random((BATCH, 3, TRAIN_TILE, TRAIN_TILE),
                                          dtype=np.float32) * 0.3
    a, b = task.predict_step(rgb), task.predict_step(rgb)
    log("pix2pix", f"serving forward in eval mode {rgb.shape}: finite "
        f"{bool(np.isfinite(a).all())}, twice bit for bit {np.array_equal(a, b)}, "
        f"G in training mode after it: {task.netG.training}")
    if not (np.isfinite(a).all() and np.array_equal(a, b) and not task.netG.training):
        raise AssertionError("pix2pix serving forward")
    ms = time_ms(lambda: task.train_step(state, ex), iters=5)
    log("pix2pix", f"bf16 fused step, batch {TRAIN_BATCH} at {TRAIN_TILE}^2: "
        f"{ms:.3f} ms ({TRAIN_BATCH / ms * 1e3:.2f} images/s)")


def padded_generator(padding: str):
    """A maker of the full-width resnet_9blocks generator with the trunk's
    ``padding`` (replicate or zero), bf16, holding a task's own weights."""
    from nirgan_tpu_torch.models import ResnetGenerator

    def make(task):
        G = ResnetGenerator(3, 1, 64, n_blocks=9, padding_type=padding,
                            compute_dtype=torch.bfloat16, device=task.device)
        G.load_state_dict(task.netG.state_dict(), strict=True)
        return G.eval()
    return make


def phase_variants() -> dict:
    """resnet_9blocks with dropout: one step (launches, gradients, the
    plain route, bit for bit from the same seed and dropout generator).
    The replicate and zero trunks (kernel A's ``pad=0`` mode after the pad):
    one serving forward of 4 x 532^2 and one step each, kernel A's calls
    counted, against the plain route, the step bit for bit (the replicate
    pad's fixed-order adjoint).  ``netD: pixel``: one step.
    ``gradient_penalty`` in f32 (TF32 off) on the card against the CPU:
    through a batch-norm and through an instance-norm ``basic`` D, all three
    ``gp_type``s, and through an instance-norm ``pixel`` D (B and B4
    counted).  Returns kernel A's calls on the padded trunks."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.losses import gan
    from nirgan_tpu_torch.models import define_D
    from nirgan_tpu_torch.tasks import Px2PxTask

    dev = torch.device("cuda")

    def step_checked(what, cfg, want, netg=None):
        task = Px2PxTask(cfg, device="cuda", seed=SEED)
        plain = Px2PxTask(cfg, device="cuda", seed=SEED)
        if netg is not None:
            task.netG, plain.netG = netg(task), netg(plain)
        ex = task.extract_batch(first_batch(cfg))
        reset_counts()
        got = loss_terms(task.train_step(task.init_state(), ex))
        torch.cuda.synchronize()
        per_step = counts()
        no_library(what)
        log("variants", f"{what}: launches per step {per_step} (want {want})")
        if per_step != want:
            raise AssertionError(f"{what}: launches {per_step} != {want}")
        check_gradients(task)
        check_repeat(what, cfg, ex, got, grads_and_stats(task), netg)
        with plain_route():
            ref = loss_terms(plain.train_step(plain.init_state(), ex))
        check_terms(f"{what}: bf16 step 1, kernels vs plain route", got, ref, 2e-2, 1e-3)
        return per_step

    cfg = load_config(CONFIG)
    cfg.base_configs.no_dropout = False
    step_checked("resnet_9blocks with dropout", cfg, STEP_LAUNCHES)

    x = (torch.rand((BATCH, SIDE, SIDE, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
    pad0 = {}
    for padding in ("replicate", "zero"):
        make = padded_generator(padding)
        G = make(Px2PxTask(load_config(CONFIG), device="cuda", seed=SEED))
        with torch.inference_mode():
            reset_counts()
            y = G(x)
            torch.cuda.synchronize()
            forward = counts()
            with plain_route():
                y_plain = G(x)
        db = psnr(y, y_plain, 2.0)
        log("variants", f"{padding} trunk forward {tuple(x.shape)}: launches "
            f"{forward}, kernels vs plain route PSNR {db:.2f} dB (bound 40)")
        if forward != EVAL_LAUNCHES or not db >= 40.0 or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{padding} trunk forward: {forward}, {db}")
        del G, y, y_plain
        step = step_checked(f"{padding} trunk", load_config(CONFIG), STEP_LAUNCHES, make)
        pad0[padding] = {"per_forward": forward["trunk_conv"],
                         "per_step": step["trunk_conv"],
                         "launches": forward["trunk_conv"] + step["trunk_conv"]}

    cfg = load_config(CONFIG)
    cfg.base_configs.netD = "pixel"
    # the pixel D's one norm a forward: D's three forwards, its backward in
    # the D loss (two) and in the G loss (one)
    want = {**STEP_LAUNCHES, "instance_norm": 26, "instance_norm_bwd": 26}
    step_checked("netD pixel", cfg, want)

    # gradient_penalty: f32 (TF32 off), the same weights and alpha on both
    g = torch.Generator().manual_seed(SEED)
    real, fake = (torch.rand((2, TRAIN_TILE, TRAIN_TILE, 4), generator=g)
                  for _ in range(2))
    alpha = torch.rand((2, 1, 1, 1), generator=g)
    with cudnn_tf32(False), mock.patch.object(
            gan, "interpolation_weights",
            lambda n, ndim, generator, device: alpha.to(device)):
        for norm, netd, gp_types in (("batch", "basic", ("mixed", "real", "fake")),
                                     ("instance", "basic", ("mixed", "real", "fake")),
                                     ("instance", "pixel", ("mixed",))):
            nets = {d: define_D(4, 64, netd, norm=norm,
                                generator=torch.Generator().manual_seed(SEED)).to(d)
                    for d in ("cuda", "cpu")}
            if norm == "instance":
                # f32's own error through the norm's second order, in f64
                nets["f64"] = define_D(4, 64, netd, norm=norm, compute_dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(SEED)).double()
            # the conv biases ahead of an instance norm, which removes them
            ahead = (() if norm != "instance" else ("conv1.bias",) if netd == "pixel"
                     else ("conv1.bias", "conv2.bias", "conv3.bias"))
            for gp_type in gp_types:
                penalty_card_vs_cpu(nets, real, fake, gp_type,
                                    f"the {norm}-norm {netd} D", ahead)
        # the penalty's time: the penalty and D's gradients through it, the
        # instance-norm basic D, kernels vs plain route
        net = define_D(4, 64, "basic", norm="instance",
                       generator=torch.Generator().manual_seed(SEED)).to(dev)
        r, f = real.to(dev), fake.to(dev)

        def penalty_step():
            net.zero_grad(set_to_none=True)
            gan.gradient_penalty(net, r, f, "mixed").backward()

        def plain_penalty_step():
            with plain_route():
                penalty_step()

        ms, plain_ms = compare_ms(penalty_step, plain_penalty_step, iters=10)
    log("variants", f"gradient_penalty mixed and D's gradients through it, the "
        f"instance-norm basic D at 2 x {TRAIN_TILE}^2, f32 (TF32 off): kernels "
        f"{ms:.3f} ms, plain route {plain_ms:.3f} ms")
    return pad0


def without_a_y(full):
    """``full`` (``instance_norm_bwd_bwd``) with the A y term of its dx
    dropped, a second order that is wrong: the control of the penalty
    check."""
    from nirgan_tpu_torch.ops import instance_norm as inm

    def control(x, g, stats, relu, v):
        dx, dg = full(x, g, stats, relu, v)
        gm = inm._wide(g) * (inm._normalized(x, stats) > 0) if relu else inm._wide(g)
        v32, y, r = inm._wide(v), inm._y(x, stats), stats[:, 1, None, None, :]

        def mean(a):
            return a.mean(dim=(1, 2), keepdim=True)

        a = mean(v32 * gm) - mean(gm) * mean(v32) - mean(gm * y) * mean(v32 * y)
        return (dx + r.square() * a * y).to(x.dtype), dg

    return control


def penalty_card_vs_cpu(nets: dict, real: torch.Tensor, fake: torch.Tensor,
                        gp_type: str, what: str, ahead: tuple = ()) -> None:
    """``gradient_penalty`` and D's gradients through it (the second order,
    ``create_graph=True``) on the card against the CPU, f32: the penalty
    within 1e-4, each gradient within 1e-3 of its largest value; where
    ``nets`` holds an f64 D (``"f64"``, on the CPU), each card gradient
    within 1e-1 of its largest value from that one's.  Through the instance
    norm's second order, E[x^2] - E[x]^2 in f32 (the JAX formula) is
    ill-posed on some inputs: at 256^2 with ndf 64 the plain route lies up
    to 2.2e-2 from f64 (``gp_type`` fake, on the card and the CPU alike), so
    the f32 routes are held to f64, not to each other; with ``gp_type`` real
    the kernels at most 1.5x the card's plain route's distance from it (B
    adds its sums exactly).  Two more runs on the
    card, reported: the kernels with B's forward (its output and moments)
    replaced by the plain forward's, which shows how much of the kernels'
    distance comes from B's moments; and a control, the kernels with the A y
    term of the second order's dx dropped, which the check must reject
    (1.2-1.4 from f64 on the CPU).  The conv biases ``ahead`` of an instance
    norm, whose gradient is zero in exact arithmetic, within 1e-5 of the
    network's largest gradient on both sides (the tests' rule,
    ``_ahead_of_a_norm``); a D with the instance norm launches B and B4
    under ``create_graph`` on the card, and its backward the second-order
    terms."""
    from nirgan_tpu_torch.losses import gan
    from nirgan_tpu_torch.ops import instance_norm as inm

    vals, launched = {}, {}
    runs = list(nets.items()) + ([("cuda plain", nets["cuda"]),
                                  ("cuda plain B", nets["cuda"]),
                                  ("cuda control", nets["cuda"])] if "f64" in nets else [])
    for d, net in runs:
        net.zero_grad(set_to_none=True)
        reset_counts()
        dev, dt = ("cpu", torch.float64) if d == "f64" else (d.split()[0], torch.float32)
        route = {"cuda plain": plain_route(),
                 "cuda plain B": mock.patch.object(inm, "instance_norm_cuda",
                                                   inm.instance_norm_plain),
                 "cuda control": mock.patch.object(
                     inm, "instance_norm_bwd_bwd",
                     without_a_y(inm.instance_norm_bwd_bwd))}.get(d)
        with route or contextlib.nullcontext():
            p = gan.gradient_penalty(net, real.to(dev, dt), fake.to(dev, dt), gp_type)
            p.backward()
        if d == "cuda":
            launched = counts()
        vals[d] = (float(p.detach()), {k: q.grad.detach().cpu() for k, q in
                                       net.named_parameters() if q.grad is not None})
    err = abs(vals["cuda"][0] - vals["cpu"][0]) / abs(vals["cpu"][0])

    def apart(a, b):
        return float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)

    # each gradient's distance from the CPU's, or where there is one from
    # the f64 evaluation's, over its bound
    if "f64" in vals:
        ratio = {k: apart(vals["cuda"][1][k], vals["f64"][1][k]) / 1e-1
                 for k in vals["cpu"][1] if k not in ahead}
    else:
        ratio = {k: apart(vals["cuda"][1][k], v) / 1e-3
                 for k, v in vals["cpu"][1].items() if k not in ahead}
    worst = max(ratio, key=ratio.get)
    own = {}
    if "f64" in vals:
        # f32's own distance from f64 on the CPU, the card's plain route, the
        # kernels, the kernels after the plain forward, and the control
        own = {d: max(apart(vals[d][1][k], vals["f64"][1][k]) for k in ratio)
               for d in ("cpu", "cuda plain", "cuda", "cuda plain B", "cuda control")}
        log("variants", f"gradient_penalty {gp_type} through {what}: the largest "
            f"distance of a gradient from f64's (relative to its largest) on the CPU "
            f"{own['cpu']:.2e}, on the card's plain route {own['cuda plain']:.2e}, on "
            f"the kernels {own['cuda']:.2e}, on the kernels after the plain forward "
            f"{own['cuda plain B']:.2e}; the control (A y dropped) "
            f"{own['cuda control']:.2e} (bound 1e-1: must fail)")
        if not own["cuda control"] > 1e-1:
            raise AssertionError(f"gradient_penalty {gp_type} through {what}: the check "
                                 f"passes a second order without A y: {own}")
        # B's sums as exact pairs: the kernels as near f64 as the plain route
        # (the sequential sums they had read 2.12e-2 against its 7.79e-3)
        if gp_type == "real" and not own["cuda"] <= 1.5 * own["cuda plain"]:
            raise AssertionError(f"gradient_penalty {gp_type} through {what}: the kernels "
                                 f"lie {own['cuda']:.2e} from f64, over 1.5x the plain "
                                 f"route's {own['cuda plain']:.2e}")
    net_max = max(float(v.abs().max()) for v in vals["cpu"][1].values())
    noise = max([float(torch.maximum(vals["cuda"][1][k].abs(), v.abs()).max()) / net_max
                 for k, v in vals["cpu"][1].items() if k in ahead] or [0.0])
    instance = any(getattr(m, "norm_type", None) == "instance"
                   for m in nets["cpu"].modules())
    log("variants", f"gradient_penalty {gp_type} through {what}, card vs CPU (TF32 off): "
        f"{vals['cuda'][0]:.6g} vs {vals['cpu'][0]:.6g}, relative {err:.2e} (bound "
        f"1e-4); D's gradients: worst |err| / bound {ratio[worst]:.3f} ({worst}; bound 1e-3 "
        f"of the largest from the CPU's, or 1e-1 from f64's), "
        f"the biases ahead of "
        f"a norm {noise:.2e} of the largest (bound 1e-5); B, B4 launches "
        f"{launched['instance_norm']}, {launched['instance_norm_bwd']}")
    if not (err <= 1e-4 and ratio[worst] <= 1.0 and noise <= 1e-5):
        raise AssertionError(f"gradient_penalty {gp_type} through {what}: {err}, "
                             f"{worst} {ratio[worst]}, {noise}")
    if instance and not (launched["instance_norm"] and launched["instance_norm_bwd"]):
        raise AssertionError(f"gradient_penalty did not go through B and B4: {launched}")
    if instance:
        PENALTY_LAUNCHES[what] = launched


def phase_baselines(tmp: str) -> None:
    """``python -m nirgan_tpu_torch.train --baseline y --max-steps 4`` (its
    ``main``: ``config_baselines.yaml``, Linear_NIR, batch 32 of 256^2, bf16,
    on the card); then each of Linear_NIR, MLP_NIR and CNN_NIR: one step on
    the config's first batch and one forward of 4 tiles, finite, timed."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import BaselineTask
    from nirgan_tpu_torch.train import cli

    run = os.path.join(tmp, "run_baseline")
    reset_counts()
    t0 = time.perf_counter()
    final = cli.main(["--baseline", "y", "--max-steps", "4", "--logdir", run,
                      "--log-every", "1"])
    dt = time.perf_counter() - t0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "train/loss" in r]
    val = [r for r in rows if "val/L1" in r]
    log("baselines", f"CLI --baseline y: {final.step} steps in {dt:.2f} s (set-up "
        f"included); train/loss {[round(r['train/loss'], 5) for r in train]}; val "
        f"rows at {[r['step'] for r in val]}; kernel calls {counts()}")
    if (final.step != 4 or len(train) != 4 or not val
            or not all(math.isfinite(r["train/loss"]) for r in train)
            or not os.path.isfile(os.path.join(run, "last.pt"))):
        raise AssertionError(f"baseline CLI: {final.step}, {len(train)}, {len(val)}")
    for name in BASELINE_MODELS:
        cfg = load_config(BASELINE_CONFIG)
        cfg.base_configs.model_name = name
        task = BaselineTask(cfg, device="cuda", seed=SEED)
        state = task.init_state()
        batch = first_batch(cfg)
        ex = task.extract_batch(batch)
        m = {k: float(v) for k, v in task.train_step(state, ex).items()}
        out = task.predict_step(batch["rgb"][:BATCH])
        ms = time_ms(lambda: task.train_step(state, ex), iters=5)
        log("baselines", f"{name}: step on {batch['rgb'].shape}: train/loss "
            f"{m['train/loss']:.5f}, {ms:.3f} ms a step; forward {out.shape} finite "
            f"{bool(np.isfinite(out).all())}")
        if (not all(math.isfinite(v) for v in m.values())
                or out.shape != (BATCH, 1, TRAIN_TILE, TRAIN_TILE)
                or not np.isfinite(out).all()):
            raise AssertionError(f"baseline {name}: {m}, {out.shape}")


PRETRAIN_BATCH, PRETRAIN_SIDE, PRETRAIN_STEPS = 32, 256, 20


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 set to ``on`` (PyTorch's default is on) and the
    matmuls' off (the default) for the block, then as they were."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = on, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def pretrain_batches(channels: int, n: int, side: int = 0, batch: int = 0) -> list:
    """``n`` host batches (of ``PRETRAIN_BATCH`` at ``PRETRAIN_SIDE``
    unless given) of the geo-mode procedural S2Geo data (NCHW images,
    lon/lat), seed 0, through the port's loader."""
    from nirgan_tpu_torch.data.pipeline import Loader
    from nirgan_tpu_torch.data.s2geo import FakeS2GeoDataset

    batch = batch or PRETRAIN_BATCH
    ds = FakeS2GeoDataset(length=batch * n, crop=side or PRETRAIN_SIDE,
                          channels=channels, mode="geo", seed=SEED)
    return list(Loader(ds, batch, num_workers=8))


def full_width_task(**kw):
    """The pretrain task with the CLI's default model, on the card."""
    from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask

    return SatClipPretrainTask(device="cuda", seed=SEED, **kw)


def check_cli_defaults(task) -> None:
    """The task's defaults are the pretrain CLI's: CLIP ModifiedResNet-50
    (layers 3, 4, 6, 3; width 64) over 4 bands at 256^2, embed 256, siren
    over L = 10 spherical harmonics."""
    from nirgan_tpu_torch.models.satclip.model import ModifiedResNet, SirenNet
    from nirgan_tpu_torch.pretrain_satclip import parse_args

    args, v = parse_args([]), task.model.visual
    layers = tuple(len(getattr(v, f"layer{i}")) for i in range(1, 5))
    got = (type(v), layers, v.conv3.weight.shape[0], task.in_channels,
           task.image_resolution, task.hparams, type(task.model.location.nnet))
    want = (ModifiedResNet, tuple(args.resnet_layers), args.vision_width, 4,
            args.image_size, {"le_type": args.le_type, "pe_type": args.pe_type,
                              "legendre_polys": args.legendre_polys,
                              "harmonics_calculation": "analytic",
                              "embed_dim": args.embed_dim}, SirenNet)
    if got != want:
        raise AssertionError(f"pretrain task defaults {got} are not the CLI's {want}")


def pretrain_run(task, batches: list, steps: int) -> tuple:
    """``steps`` train steps cycling over ``batches`` from a fresh train
    state: (state, the device batches, the losses)."""
    state = task.init_state()
    exs = [task.extract_batch(b) for b in batches]
    losses = [task.train_step(state, exs[i % len(exs)])["train_loss"]
              for i in range(steps)]
    return state, exs, torch.stack(losses).tolist()


def pretrain_stepper():
    """The CLI's default pretrain step (full width, batch 32) on one
    geo-mode batch, for the profile."""
    task = full_width_task()
    state = task.init_state()
    ex = task.extract_batch(pretrain_batches(4, 1)[0])
    return lambda: task.train_step(state, ex)


def running_stats(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def shared_dropout(seed: int):
    """Dropout masks from a CPU generator seeded with ``seed``, copied to
    the layer's device: two runs on two devices draw the same masks."""
    from nirgan_tpu_torch.models import layers

    g = torch.Generator().manual_seed(seed)

    def draw(shape, keep_prob, generator, device):
        return (torch.rand(shape, generator=g) < keep_prob).to(device)

    return mock.patch.object(layers, "keep_mask", draw)


def phase_satclip_pretrain(tmp: str) -> tuple:
    """SatCLIP pretraining on the card (the module docstring's list);
    returns the timed full-width step for ``phase_pretrain_profile``."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models.satclip import SatClipWrapper
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask

    laps = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        laps.append((name, time.perf_counter()))

    batches = pretrain_batches(4, 4)
    lap("data")
    with cudnn_tf32(True):
        # --- the CLI's default model at full width
        task = full_width_task()
        check_cli_defaults(task)
        n_params = sum(p.numel() for p in task.model.parameters())
        stats0 = running_stats(task.model)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, exs, losses = pretrain_run(task, batches, PRETRAIN_STEPS)
        torch.cuda.synchronize()
        launched = counts()
        after = {k: p.detach().clone() for k, p in task.model.named_parameters()}
        stats1 = running_stats(task.model)
        moved = [k for k in stats0 if not torch.equal(stats0[k], stats1[k])]
        first, last = np.mean(losses[:4]), np.mean(losses[-4:])
        log("pretrain", f"CLIP ModifiedResNet-50 (width "
            f"{task.model.visual.conv3.weight.shape[0]}, {n_params} params), 4 x "
            f"{PRETRAIN_SIDE}^2, embed 256, siren L=10, batch {PRETRAIN_BATCH}, "
            f"{PRETRAIN_STEPS} steps over 4 batches: loss "
            f"{', '.join(f'{v:.4f}' for v in losses)}; batch 0 at step 1 "
            f"{losses[0]:.4f}, at step 17 {losses[16]:.4f}; first 4 {first:.4f}, last "
            f"4 {last:.4f}; {len(moved)} of {len(stats0)} running statistics moved; "
            f"kernel calls {launched}")
        # 55 batch norms (3 in the stem, 3 a block, 4 downsample branches)
        if (not all(math.isfinite(v) for v in losses) or not last < first
                or len(moved) != len(stats0) or len(stats0) != 2 * 55
                or any(launched.values())):
            raise AssertionError(f"pretrain: {losses}, {len(moved)}/{len(stats0)}, "
                                 f"{launched}")
        rounds = [time_ms(lambda: task.train_step(state, exs[0]), iters=5, warmup=1)
                  for _ in range(3)]
        ms = float(np.median(rounds))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log("pretrain", f"step {', '.join(f'{r:.3f}' for r in rounds)} ms (CUDA events, "
            f"3 rounds of 5): median {ms:.3f} ms, {PRETRAIN_BATCH / ms * 1e3:.1f} "
            f"images/s; peak device memory {peak:.2f} GiB")
        full = (task, state, exs[0], ms)
        lap("full width")

        # --- the same 20 steps from the same seed
        again = full_width_task()
        pretrain_run(again, batches, PRETRAIN_STEPS)
        differ = {k: float((p.detach() - after[k]).abs().max())
                  for k, p in again.model.named_parameters()
                  if not torch.equal(p.detach(), after[k])}
        log("pretrain", f"second run from the same seed: {len(after) - len(differ)} of "
            f"{len(after)} parameters bit for bit after {PRETRAIN_STEPS} steps"
            + (f"; differ: {sorted(differ.items(), key=lambda kv: -kv[1])[:5]}"
               if differ else ""))
        del again
        if differ:
            check_pretrain_step_repeats(batches[0])
        lap("repeat")

        # --- the frozen moco towers, 13 bands
        batches13 = pretrain_batches(13, 2)
        for name in ("moco_resnet50", "moco_vit16"):
            check_moco(name, batches13)
        del batches13
        lap("moco")

    # --- f32 card against CPU, TF32 off
    with cudnn_tf32(False):
        check_pretrain_f32()
    lap("f32")

    # --- the CLI on the card, then its run as the inject GAN's tower
    out = os.path.join(tmp, "satclip_pretrain")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nirgan_tpu_torch.pretrain_satclip",
                           "--fake-geo", "--steps", "20", "--out", out],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    lap("CLI")
    if proc.returncode != 0:
        raise AssertionError(f"pretrain CLI failed: {proc.stderr[-3000:]}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    log("pretrain", f"python -m nirgan_tpu_torch.pretrain_satclip --fake-geo --steps 20: "
        f"{dt:.1f} s (process start and set-up included; the loop's own clock "
        f"{[(r['step'], r['elapsed_s']) for r in steps]} s); train_loss at steps "
        f"{[(r['step'], round(r['train_loss'], 4)) for r in rows]}")
    if [r["step"] for r in rows] != [1, 10, 20] or not all(
            math.isfinite(r["train_loss"]) for r in rows):
        raise AssertionError(f"pretrain CLI rows: {rows}")
    wrapper = SatClipWrapper(out)
    cfg = load_config(SATCLIP_CONFIG)
    cfg.satclip.satclip_path = out
    gan = Px2PxTask(cfg, seed=SEED)
    batch = first_batch(cfg)
    m = gan.train_step(gan.init_state(), gan.extract_batch(batch))
    pred = gan.predict_step(batch["rgb"][:BATCH], batch["coords"][:BATCH])
    loc = SatClipPretrainTask(vision_layers=(1, 1, 1, 1), vision_width=8,
                              image_resolution=32, device="cuda")
    ckpt = torch.load(os.path.join(out, "satclip.ckpt"), map_location="cpu",
                      weights_only=False)
    loc.model.location.load_state_dict(
        {k[len("model.location."):]: v for k, v in ckpt["state_dict"].items()
         if k.startswith("model.location.")})
    coords = np.random.default_rng(3).uniform([-180, -90], [180, 90], (64, 2))
    want = loc.location_encoder()(coords)
    got = wrapper.predict(coords)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    total = float(m["model_loss/generator_total_loss"])
    log("pretrain", f"the run as satclip_path of {os.path.basename(SATCLIP_CONFIG)}: "
        f"wrapper loaded {wrapper.loaded_from == out}, the GAN's tower from it "
        f"{gan.satclip_model.loaded_from == out}; one inject train step (batch "
        f"{batch['rgb'].shape[0]}): G total {total:.4f}; served {pred.shape}, finite "
        f"{bool(np.isfinite(pred).all())}; the wrapper's float64 embeddings against "
        f"the pretrain task's location_encoder (f32 on the card): max|err| {err:.2e} "
        f"of the largest (bound 5e-05)")
    if not (wrapper.loaded_from == out and gan.satclip_model.loaded_from == out
            and math.isfinite(total) and np.isfinite(pred).all()
            and pred.shape == (BATCH, 1, TRAIN_TILE, TRAIN_TILE) and err <= 5e-5):
        raise AssertionError(f"pretrain -> inject: {total}, {pred.shape}, {err}")
    del gan, loc
    lap("inject")

    log("pretrain", f"phase {laps[-1][1] - laps[0][1]:.1f} s ("
        + ", ".join(f"{name} {t - laps[i][1]:.1f}" for i, (name, t) in enumerate(laps[1:]))
        + "); the step's profile comes last in the run")
    return full


def phase_pretrain_profile(full: tuple) -> None:
    """Where the full-width pretrain step's time goes, under
    ``torch.profiler`` with cuDNN in TF32 as it was timed: the busy time
    against the CUDA-event time read before any profiler attached (the
    card's idle share).  Run after every other phase: an attached profiler
    slows every later launch on the host, and in one run the profiles that
    followed this window (about 17,500 kernels) recorded no kernel at all.
    A window that records none is counted again, at most twice."""
    task, state, ex, ms = full
    with cudnn_tf32(True):
        for _ in range(3):
            busy = profile_window(
                f"SatCLIP pretrain step, full width, batch {PRETRAIN_BATCH}",
                lambda: task.train_step(state, ex), 5)
            if busy > 0:
                break
            log("pretrain", "the profiler recorded no kernel of the step; counting again")
    log("pretrain", f"full-width step: device busy {busy:.3f} ms under the profiler "
        f"against {ms:.3f} ms by CUDA events before it: idle share "
        f"{max(0.0, 1 - busy / ms):.1%}")
    if not busy > 0:
        raise AssertionError("pretrain profile: the profiler recorded no kernel")


def check_pretrain_step_repeats(host: dict) -> None:
    """Where 20 steps do not repeat bit for bit: one step's gradients of
    two runs from the same seed, each within 1e-4 of its own largest entry,
    and the tensors that differ named."""
    grads = []
    for _ in range(2):
        task = full_width_task(accumulate_grad_batches=2)
        state = task.init_state()
        task.train_step(state, task.extract_batch(host))  # gradients kept
        grads.append({k: p.grad.clone() for k, p in task.model.named_parameters()})
        del task
    a, b = grads
    rel = {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
           for k in a if not torch.equal(a[k], b[k])}
    log("pretrain", f"one step's gradients twice from the same seed: {len(a) - len(rel)} "
        f"of {len(a)} bit for bit; differ (relative to their largest entry): "
        f"{sorted(rel.items(), key=lambda kv: -kv[1])[:8]} (bound 1e-4)")
    if any(v > 1e-4 for v in rel.values()):
        raise AssertionError(f"pretrain step does not repeat: {rel}")


def check_moco(name: str, batches: list) -> None:
    """A frozen timm tower at 13 bands: a few steps, the tower bit for bit
    but its statistics, the head and the location network moved, step ms."""
    from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask

    task = SatClipPretrainTask(vision_layers=name, device="cuda", seed=SEED)
    head = task.pretrained_head
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    state, exs, losses = pretrain_run(task, batches, 4)
    now = task.model.state_dict()
    params = dict(task.model.named_parameters())
    frozen = [k for k, p in params.items() if not p.requires_grad]
    changed = [k for k in frozen if not torch.equal(before[k], now[k])]
    trained = [k for k in params if k.startswith((f"visual.{head}.", "location."))]
    still = [k for k in trained if torch.equal(before[k], now[k])]
    stats = [k for k in now if "running" in k]
    stats_moved = [k for k in stats if not torch.equal(before[k], now[k])]
    ms = float(np.median([time_ms(lambda: task.train_step(state, exs[0]), iters=3,
                                  warmup=1) for _ in range(3)]))
    log("pretrain", f"{name} (13 x {PRETRAIN_SIDE}^2, batch {PRETRAIN_BATCH}): loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}; {len(frozen)} frozen tensors, "
        f"{len(changed)} changed; {len(trained) - len(still)} of {len(trained)} head "
        f"and location tensors moved; {len(stats_moved)} of {len(stats)} running "
        f"statistics moved; step {ms:.3f} ms ({PRETRAIN_BATCH / ms * 1e3:.1f} images/s)")
    if (changed or still or not frozen or len(stats_moved) != len(stats)
            or ("resnet" in name) != bool(stats)
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{name}: frozen changed {changed}, still {still}, "
                             f"stats {len(stats_moved)}/{len(stats)}")


def check_pretrain_f32() -> None:
    """A reduced model (layers (1, 1, 1, 1), width 16, 64^2, batch 8) in f32,
    TF32 off: one step on the card and on the CPU from the same seed and
    the same dropout masks; the loss (1e-5), every gradient (1e-4 of its
    own largest entry; the attention pool's key bias, zero in exact
    arithmetic, below 1e-5 of the largest gradient) and, after a second
    step (the update, K = 2), ``location_encoder``'s embeddings (1e-5 of
    the largest)."""
    from nirgan_tpu_torch.tasks.satclip_pretrain import SatClipPretrainTask

    host = pretrain_batches(4, 1, side=64, batch=8)[0]
    coords = np.random.default_rng(5).uniform([-180, -90], [180, 90], (16, 2))
    runs = []
    for device in ("cuda", "cpu"):
        task = SatClipPretrainTask(vision_layers=(1, 1, 1, 1), vision_width=16,
                                   image_resolution=64, accumulate_grad_batches=2,
                                   device=device, seed=SEED)
        state = task.init_state()
        with shared_dropout(SEED):
            ex = task.extract_batch(host)
            loss = float(task.train_step(state, ex)["train_loss"])
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in task.model.named_parameters()}
            task.train_step(state, ex)
        runs.append((loss, grads, task.location_encoder()(coords)))
    (loss, grads, emb), (loss_c, grads_c, emb_c) = runs
    net_max = max(float(g.abs().max()) for g in grads_c.values())
    worst, key_bias = 0.0, 0.0
    for k, g in grads.items():
        if k.endswith("k_proj.bias"):
            key_bias = max(float(g.abs().max()), float(grads_c[k].abs().max())) / net_max
            continue
        worst = max(worst, float((g - grads_c[k]).abs().max())
                    / float(grads_c[k].abs().max()))
    loss_err = abs(loss - loss_c) / abs(loss_c)
    emb_err = float(np.abs(emb - emb_c).max()) / float(np.abs(emb_c).max())
    log("pretrain f32", f"reduced model, batch 8 at 64^2, card vs CPU (TF32 off): loss "
        f"{loss:.6f} vs {loss_c:.6f} (rel {loss_err:.2e}, bound 1e-05); worst gradient "
        f"{worst:.2e} of its largest entry (bound 1e-04), key bias {key_bias:.2e} of the "
        f"largest gradient (bound 1e-05); embeddings after the update {emb_err:.2e} "
        f"(bound 1e-05)")
    if not (loss_err <= 1e-5 and worst <= 1e-4 and key_bias <= 1e-5 and emb_err <= 1e-5):
        raise AssertionError(f"pretrain f32 card vs CPU: {loss_err}, {worst}, "
                             f"{key_bias}, {emb_err}")


# kernel-name fragments -> the rows of the profile's breakdown, first match
# ------------------------------------------------------- validation tools
VAL_SAMPLES, VAL_BATCH = 64, 8  # the sweep's samples and the spider's batch
# wrapper calls of one sweep batch: one serving forward
VAL_LAUNCHES = {k: EVAL_LAUNCHES[k] for k in SERVING_KERNELS}
VAL_METRICS = ("ssim", "psnr", "l1", "l2", "l1_ndvi", "l1_ndwi", "l1_evi")
# kernels vs plain route, bf16: the [0, 1]-scaled columns within 1e-2 (a
# bf16 ulp of the ~0.76 outputs is 4e-3, and the columns are means over
# 240^2 pixels of differences of both signs), PSNR within 0.1 dB
VAL_ATOL, VAL_PSNR_DB = 1e-2, 0.1


def validation_config(tmp: str, name: str = "validation.yaml", **tpu) -> str:
    """``config_px2px.yaml`` as shipped but for a fake val split of
    ``VAL_SAMPLES`` 256^2 samples with coordinates (the split is an eighth
    of ``length``), written to a file for the CLI."""
    from nirgan_tpu_torch.config import load_config, save_config

    cfg = load_config(CONFIG)
    cfg.Data.fake_settings.length = 8 * VAL_SAMPLES
    cfg.Data.fake_settings.return_coords = True
    for key, value in tpu.items():
        cfg.tpu[key] = value
    path = os.path.join(tmp, name)
    save_config(cfg, path)
    return path


def positive_head(task) -> None:
    """The head's bias at 1 and its weight scaled by 0.1, in place: the
    NIR comes out in about (0.7, 0.8), as a trained generator's lies in
    (0, 1), so that the spectral-index columns are away from the poles of
    their ratios (a random head's negative output sits on them, where no
    rounding bound holds)."""
    with torch.no_grad():
        task.netG.c1.bias.fill_(1.0)
        task.netG.c1.weight.mul_(0.1)


def sweep(task, ds, folder: str, n: int = VAL_SAMPLES) -> tuple:
    """The spider sweep of ``task`` over ``n`` samples of ``ds`` into
    ``folder``: (its rows, the predictions, host s, device ms of the
    forwards and of the metric program by CUDA events)."""
    from nirgan_tpu_torch.validation import spider

    preds, spans = [], {"forward": [], "metrics": []}
    serve, measure = task.predict_step, spider.per_sample_metrics

    def timed(kind, fn):
        def run(*args):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            out = fn(*args)
            marks[1].record()
            spans[kind].append(marks)
            return out
        return run

    def predict(*args):
        preds.append(timed("forward", serve)(*args))
        return preds[-1]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(task, "predict_step", predict), \
         mock.patch.object(spider, "per_sample_metrics", timed("metrics", measure)):
        rows = spider.spider_validation_callback(task, ds, satclip=task.satclip,
                                                 folder=folder, max_samples=n)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    device = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return rows, np.concatenate(preds), host_s, device


def metric_gap(got, ref) -> dict:
    """The worst |difference| of each metric column."""
    return {k: float(np.max(np.abs(got[k].values - ref[k].values))) for k in VAL_METRICS}


def check_validation_files(folder: str, n: int, tag: str, epoch: int = 0) -> "object":
    """The sweep's CSV and GeoJSON in ``folder``: ``n`` rows and features,
    every metric finite; returns the GeoJSON as a table."""
    import pandas as pd

    from nirgan_tpu_torch.validation.spiders import read_metric_geojson

    satclip = tag == "True"
    csv = pd.read_csv(os.path.join(folder, "validation_metrics.csv"))
    geo = read_metric_geojson(os.path.join(
        folder, f"validation_metrics_ablation_satclip_{satclip}_e{epoch}.geojson"))
    finite = bool(np.isfinite(geo[list(VAL_METRICS)].values).all())
    if len(csv) != n or len(geo) != n or not finite:
        raise AssertionError(f"{folder}: {len(csv)} CSV rows, {len(geo)} features "
                             f"(want {n}), finite {finite}")
    return geo


def phase_validation(tmp: str) -> dict:
    """The validation tools on the card: ``python -m nirgan_tpu_torch.validate``
    on a derived ``config_px2px.yaml`` (64 val samples), the same sweep in
    process on the kernels against the plain route and again bit for bit,
    with ``--quant int8``, ``--compare``, f32 card against CPU, the
    flagship trainer's ``save_val_df`` sweep over two epochs, and the
    export of its run as a reference ``.ckpt``.  Returns the kernels'
    launches in the bf16 and the int8 sweep."""
    from nirgan_tpu_torch import export_torch_ckpt, validate
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data import dataset_selector
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train import cli
    from nirgan_tpu_torch.validation import spider
    from nirgan_tpu_torch.weights import load_reference_weights

    cfg_path = validation_config(tmp)
    smi = smi_line()

    # --- the CLI in a process of its own, on the card by its default
    out = os.path.join(tmp, "validate_cli")
    code = ("import runpy, sys\n"
            f"sys.argv = ['validate', '--config', {cfg_path!r}, '--max-samples', "
            f"'{VAL_SAMPLES}', '--out', {out!r}]\n"
            "runpy.run_module('nirgan_tpu_torch.validate', run_name='__main__')\n"
            "print('LOADED', sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in ('jax', 'nirgan_tpu')))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"validate CLI failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    loaded = [line for line in proc.stdout.splitlines() if line.startswith("LOADED")]
    geo = check_validation_files(out, VAL_SAMPLES, "False")
    images = sorted(os.listdir(os.path.join(out, "images")))
    koppen, continents = sorted(set(geo["Koppen_Class"])), sorted(set(geo["Continent"]))
    log("validation", f"python -m nirgan_tpu_torch.validate --config <64 val samples> "
        f"--max-samples {VAL_SAMPLES}: {time.perf_counter() - t0:.2f} s with process "
        f"start; {len(geo)} rows, panels {images}, Köppen classes {koppen}, "
        f"continents {continents}; jax or the JAX package loaded: {loaded}")
    if (images != ["example_image_0000_NoSatCLIP.png", "example_image_0050_NoSatCLIP.png"]
            or loaded != ["LOADED []"] or not set(koppen) <= set("ABCDE")
            or continents == ["Unknown"]):
        raise AssertionError(f"validate CLI: {images}, {loaded}, {koppen}, {continents}")

    # --- the same sweep in process: kernels, counted; plain route; again
    cfg = load_config(cfg_path)
    ds = dataset_selector(cfg).val_ds
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    positive_head(task)
    sweep(task, ds, os.path.join(tmp, "val_warm"), VAL_BATCH)  # warm: allocations
    reset_counts()
    rows, preds, host_s, device_ms = sweep(task, ds, os.path.join(tmp, "val_kernels"))
    launches = counts()
    no_library("validation sweep")
    batches = VAL_SAMPLES // VAL_BATCH
    want = {k: batches * v for k, v in VAL_LAUNCHES.items()}
    log("validation", f"sweep of {VAL_SAMPLES} at batch {VAL_BATCH}, bf16: launches "
        f"{launches} (want {want}: A {VAL_LAUNCHES['trunk_conv']}, B "
        f"{VAL_LAUNCHES['instance_norm']}, C {VAL_LAUNCHES['head_conv']} a batch)")
    if {k: launches[k] for k in want} != want or any(
            launches[k] for k in launches if k not in want):
        raise AssertionError(f"validation sweep launches {launches} != {want}")
    # one batch's forward and metric program timed alone, the card given a
    # head start so that the host's launches do not pass for device time
    from nirgan_tpu_torch.ops.pad import reflect_pad_to
    from nirgan_tpu_torch.validation.per_sample_metrics import per_sample_metrics

    x = torch.rand((VAL_BATCH, TRAIN_TILE, TRAIN_TILE, 3), device=task.device,
                   generator=torch.Generator(device=task.device).manual_seed(SEED))
    x = reflect_pad_to(x, task.bucket_for(TRAIN_TILE, TRAIN_TILE),
                       task.bucket_for(TRAIN_TILE, TRAIN_TILE)).to(task.compute_dtype)
    crops = [x[:, 8:248, 8:248, :3].float(), x[:, 8:248, 8:248, :1].float(),
             x[:, 9:249, 9:249, :1].float()]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: task.g_apply(x), iters=10, run_ahead=True)
        metric_ms = time_ms(lambda: per_sample_metrics(*crops), iters=10,
                            run_ahead=True)
    busy = batches * (fwd_ms + metric_ms) / (host_s * 1e3)
    log("validation", f"{smi}: {VAL_SAMPLES / host_s:.2f} samples/s ({host_s:.3f} s, "
        f"host clock, panels and joins included); spans on the stream (CUDA events, "
        f"the host's launch gaps included) forwards {device_ms['forward']:.3f} ms, "
        f"metric program {device_ms['metrics']:.3f} ms for {batches} batches; alone "
        f"with the card's head start a batch's forward {fwd_ms:.3f} ms and metric "
        f"program {metric_ms:.3f} ms: the card busy about {100 * busy:.1f}% of the sweep")
    with plain_route():
        plain_rows, plain_preds, _, _ = sweep(task, ds, os.path.join(tmp, "val_plain"))
    db = psnr(torch.from_numpy(preds), torch.from_numpy(plain_preds), 2.0)
    gap = metric_gap(rows, plain_rows)
    log("validation", f"kernels vs plain route: predictions {db:.2f} dB (bound 40, "
        f"tanh range 2); worst metric gaps {gap} (bound {VAL_ATOL}, PSNR "
        f"{VAL_PSNR_DB} dB); NIR {float(preds.min()):.4f}..{float(preds.max()):.4f}")
    if not (db >= 40.0 and gap["psnr"] <= VAL_PSNR_DB
            and all(v <= VAL_ATOL for k, v in gap.items() if k != "psnr")):
        raise AssertionError(f"validation sweep vs plain route: {db} dB, {gap}")
    again, again_preds, _, _ = sweep(task, ds, os.path.join(tmp, "val_again"))
    same = np.array_equal(again_preds, preds) and all(
        np.array_equal(again[k].values, rows[k].values) for k in VAL_METRICS)
    log("validation", f"the sweep again: bit for bit {same}")
    if not same:
        raise AssertionError("the validation sweep did not repeat bit for bit")

    # --- int8: the CLI's --quant int8 in process, counted
    int8_task = Px2PxTask(load_config(validation_config(tmp, "v8.yaml",
                                                      serving_quant="int8")),
                          device="cuda", seed=SEED)
    positive_head(int8_task)
    reset_counts()
    int8_rows, _, int8_s, _ = sweep(int8_task, ds, os.path.join(tmp, "val_int8"))
    int8_launches = {**counts(), **int8_counts()}
    want8 = {"trunk_conv": EVAL_LAUNCHES["trunk_conv"],  # the calibration forward
             "int8_conv": batches * INT8_FORWARD["int8_conv"],
             "int8_norm": batches * INT8_FORWARD["int8_norm"]}
    db8 = float(np.max(np.abs(int8_rows["psnr"].values - rows["psnr"].values)))
    log("validation", f"sweep with the int8 trunk: launches {int8_launches} (want "
        f"{want8}: D {INT8_FORWARD['int8_conv']}, E {INT8_FORWARD['int8_norm']} a "
        f"batch); worst per-sample PSNR gap to the bf16 sweep {db8:.4f} dB (bound 1); "
        f"{VAL_SAMPLES / int8_s:.2f} samples/s")
    if {k: int8_launches[k] for k in want8} != want8 or not db8 <= 1.0:
        raise AssertionError(f"int8 sweep: {int8_launches}, {db8} dB")
    cli_rows = validate.main(["--config", cfg_path, "--quant", "int8", "--max-samples",
                              str(VAL_BATCH), "--out", os.path.join(tmp, "val_cli8")])
    if len(cli_rows) != VAL_BATCH or not np.isfinite(cli_rows["psnr"].values).all():
        raise AssertionError(f"validate --quant int8: {len(cli_rows)} rows")
    del int8_task

    # --- --compare: the flagship against the plain config, three radars
    folder, plots = validate.main(["--compare", SATCLIP_CONFIG, cfg_path, "--out",
                                   os.path.join(tmp, "compare"), "--max-samples",
                                   str(VAL_SAMPLES)])
    names = sorted(os.path.basename(p) for p in plots)
    log("validation", f"--compare {os.path.basename(SATCLIP_CONFIG)} <plain>: {names}")
    if len(plots) != 3 or not all(os.path.getsize(p) > 0 for p in plots):
        raise AssertionError(f"--compare wrote {plots}")
    check_validation_files(folder, 8, "True")  # the flagship's val split: 8

    # --- f32, card against CPU: two batches at a small config (TF32 off)
    small = load_config(CONFIG)
    small.tpu.compute_dtype = "float32"
    small.tpu.shape_buckets = [64]
    small.base_configs.netG = "resnet_6blocks"
    fake = small.Data.fake_settings
    fake.image_size, fake.length, fake.return_coords = 64, 16 * VAL_BATCH, True
    small_ds = dataset_selector(small).val_ds
    with cudnn_tf32(False):
        tables = []
        for device in ("cuda", "cpu"):
            t = Px2PxTask(small, device=device, seed=SEED)
            positive_head(t)
            tables.append(spider.spider_validation_callback(
                t, small_ds, satclip=False, folder=os.path.join(tmp, f"f32_{device}")))
    gap32 = metric_gap(*tables)
    log("validation", f"f32 sweep of 2 batches at 64^2, card vs CPU: worst gaps {gap32} "
        "(bound 1e-3)")
    if len(tables[0]) != 2 * VAL_BATCH or not all(v <= 1e-3 for v in gap32.values()):
        raise AssertionError(f"f32 sweep card vs CPU: {gap32}")

    # --- the flagship trainer with save_val_df (as shipped): two epochs of
    # 8 steps, a validation batch and a sweep batch at each epoch's end
    run = os.path.join(tmp, "run_val_df")
    reset_counts()
    t0 = time.perf_counter()
    final = cli.main(["--logdir", run, "--max-steps", "16", "--log-every", "8"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    trained = counts()
    want_t = {k: 16 * STEP_LAUNCHES[k] + 2 * (1 + 1) * EVAL_LAUNCHES[k]
              for k in STEP_LAUNCHES}
    for epoch in (1, 2):
        check_validation_files(run, 8, "True", epoch)
    log("validation", f"train CLI (flagship, save_val_df) 16 steps, 2 epochs in "
        f"{dt:.2f} s: sweeps e1 and e2 written; launches {trained} (want {want_t})")
    if final.step != 16 or trained != want_t:
        raise AssertionError(f"save_val_df run: step {final.step}, {trained}")

    # --- its last.pt exported and served back, bit for bit
    ckpt = os.path.join(tmp, "exported.ckpt")
    export_torch_ckpt.main(["--config", SATCLIP_CONFIG, "--ckpt",
                            os.path.join(run, "last.pt"), "--out", ckpt])
    flagship = load_config(SATCLIP_CONFIG)
    blob = torch.load(os.path.join(run, "last.pt"), map_location="cpu", weights_only=True)
    served = Px2PxTask(flagship, device="cuda", seed=SEED + 1).bind(
        load_reference_weights(ckpt, flagship)["netG"])
    original = Px2PxTask(flagship, device="cuda", seed=SEED + 1).bind(blob["G"])
    batch = first_batch(flagship)
    a = served.predict_step(batch["rgb"], batch["coords"])
    b = original.predict_step(batch["rgb"], batch["coords"])
    log("validation", f"exported {os.path.basename(ckpt)} ({os.path.getsize(ckpt)} "
        f"bytes) served back: {a.shape} bit for bit {np.array_equal(a, b)}")
    if not np.array_equal(a, b):
        raise AssertionError("the exported checkpoint does not serve the trained G")
    del task, served, original
    torch.cuda.empty_cache()
    return {"bf16": launches, "int8": int8_launches}


def validation_entry(launches: dict, name: str) -> dict:
    """A kernel's ``validation`` entry: its launches in the phase's sweep of
    ``VAL_SAMPLES`` and per batch of ``VAL_BATCH``."""
    batches = VAL_SAMPLES // VAL_BATCH
    return {"launches": launches[name], "per_batch": launches[name] / batches,
            "samples": VAL_SAMPLES, "batch": VAL_BATCH}


PROFILE_GROUPS = (
    ("igemm_s8_kernel", "D int8 conv, wgmma s8"),
    ("s8_moments_kernel", "D moments (second launch)"),
    ("igemm_wgmma_kernel<256", "wgmma implicit GEMM, N = 256 (kernel A; B5 dx at u0)"),
    ("igemm_wgmma_kernel<128", "wgmma implicit GEMM, N = 128 (B5 dx at u1)"),
    ("trunk_conv_", "kernel A, WMMA / SIMT"),
    ("convt_dw_", "B5 dW and its reduce"),
    ("convt_dx_", "B5 dx, WMMA / SIMT"),
    ("in_resident_kernel", "resident, one launch a call"),
    ("in_partial_kernel", "streaming sums"),
    ("in_apply_kernel", "streaming elementwise"),
    ("head_conv_mma_kernel", "C head, mma.sync"),
    ("int8_conv_kernel", "D int8 conv, mma.sync"),
    ("int8_moments_kernel", "D moments, mma.sync (second launch)"),
    ("int8_norm_kernel", "E int8 norm"),
    ("head_conv_kernel", "C head, f32 FMA"),
    ("reflection_pad", "reflect pad"),
    ("multi_tensor_apply", "Adam"),
    ("CatArrayBatchedCopy", "concatenations (D's inputs, U-Net skips)"),
    ("cudnn", "cuDNN convs"), ("xmma", "cuDNN convs"), ("cutlass", "cuDNN convs"),
    ("convolve", "cuDNN convs"), ("wgrad", "cuDNN convs"), ("dgrad", "cuDNN convs"),
    ("nchwToNhwc", "cuDNN layout"), ("nhwcToNchw", "cuDNN layout"),
    ("copy", "copies (layout, casts)"),
    ("reduce_kernel", "PyTorch reductions"),
    ("avg_pool", "pooling"), ("max_pool", "pooling"),
    ("gemm", "GEMMs (dense layers, attention)"), ("gemv", "GEMMs (dense layers, attention)"),
    ("softmax", "softmax, cross-entropy"), ("nll_loss", "softmax, cross-entropy"),
    ("elementwise", "PyTorch elementwise"),
)


def profile_window(what: str, fn, iters: int) -> float:
    """``iters`` calls of ``fn`` under ``torch.profiler`` after a warm-up;
    prints the device time per call of each group of kernels and returns
    the device's busy ms a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for ev in prof.key_averages():
        # kernels and device copies only: a host op's device time is its
        # kernels' over again, and so is an annotation's (Optimizer.step)
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation or not ev.device_time_total):
            continue
        total = ev.device_time_total
        label = next((g for frag, g in PROFILE_GROUPS if frag in ev.key),
                     "other: " + ev.key[:60])
        if "::in_" in ev.key or ev.key.startswith("in_"):
            # the instance norm's kernels are templates on <type, backward>
            backward = any(t in ev.key for t in (", true>", ",true>", "(bool)1>"))
            label = f"{'B4 IN backward' if backward else 'B IN forward'}, {label}"
        ms, n = groups.get(label, (0.0, 0))
        groups[label] = (ms + total / 1e3, n + ev.count)
    busy = sum(ms for ms, _ in groups.values())
    log("profile", f"{what}: device busy {busy / iters:.3f} ms a call")
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log("profile", f"  {ms / iters:8.3f} ms  {n / iters:7.1f} launches  {label}")
    norms = [v for label, v in groups.items() if label.startswith(("B IN", "B4 IN"))]
    log("profile", f"  B + B4 together: {sum(ms for ms, _ in norms) / iters:.3f} ms in "
        f"{sum(n for _, n in norms) / iters:.1f} CUDA launches a call")
    return busy / iters


def phase_profile() -> None:
    """Where the time goes (``python3 chip_smoke.py --profile``): the
    serving forward (bf16, and with the int8 trunk calibrated on its batch)
    and the fused train step of the full-width configs under
    ``torch.profiler``, the plain route (``config_px2px.yaml``, also its
    step on 512^2 tiles at 532^2), the SatCLIP
    inject route (``config_px2px_SatCLIP.yaml``), the ``unet_256`` forward
    and step and the pix2pix (batch-norm U-Net) step, on the kernels and on
    the plain versions; and the head's backward, which is PyTorch's
    convolution gradients, timed on its own."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G, define_G_inject
    from nirgan_tpu_torch.ops.head_conv import head_conv_bwd, head_conv_cuda
    from nirgan_tpu_torch.ops.int8_trunk import calibrate_trunk, quantize_trunk
    from nirgan_tpu_torch.tasks import Px2PxTask

    dev = torch.device("cuda")
    seeded = torch.Generator().manual_seed(SEED)
    G = define_G(3, 1, 64, "resnet_9blocks", "instance",
                 compute_dtype=torch.bfloat16, generator=seeded).to(dev).eval()
    G_inject = define_G_inject(load_config(SATCLIP_CONFIG),
                               compute_dtype=torch.bfloat16,
                               generator=seeded).to(dev).eval()
    x = (torch.rand((BATCH, SIDE, SIDE, 3),
                    generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
    embeds = torch.randn((BATCH, 256), generator=seeded).to(dev)

    def forward():
        with torch.inference_mode():
            G(x)

    with torch.inference_mode():
        calib = calibrate_trunk(G, x)
    with torch.no_grad():
        pack = quantize_trunk(G.state_dict(), G.n_blocks, calib)

    def forward_int8():
        with torch.inference_mode():
            G(x, trunk_q=pack)

    def forward_inject():
        with torch.inference_mode():
            G_inject(x, embeds)

    def plain(fn):
        def run():
            with plain_route():
                fn()
        return run

    def stepper(config):
        cfg = load_config(config)
        task = Px2PxTask(cfg, device="cuda", seed=SEED)
        state = task.init_state()
        ex = task.extract_batch(first_batch(cfg))
        return lambda: task.train_step(state, ex)

    def unet_stepper(**overrides):
        cfg = unet_config(**overrides)
        task = Px2PxTask(cfg, device="cuda", seed=SEED)
        state = task.init_state()
        ex = task.extract_batch(first_batch(cfg))
        return lambda: task.train_step(state, ex)

    G_unet = define_G(3, 1, 64, "unet_256", "instance", compute_dtype=torch.bfloat16,
                      generator=seeded).to(dev).eval()
    x_unet = x[:, :UNET_TILE, :UNET_TILE].contiguous()

    def forward_unet():
        with torch.inference_mode():
            G_unet(x_unet)

    def s2_stepper():
        # config_px2px.yaml's step on a batch of 16 512^2 tiles (S2_75k's
        # size), made in memory: the generator at 532^2
        task = Px2PxTask(load_config(CONFIG), device="cuda", seed=SEED)
        state = task.init_state()
        rng = np.random.default_rng(SEED)
        tiles = rng.integers(0, 10000, (TRAIN_BATCH, 4, T512_TILE, T512_TILE)).astype(np.float32)
        ex = task.extract_batch({"rgb": tiles[:, :3] / 1e4, "nir": tiles[:, 3:] / 1e4})
        return lambda: task.train_step(state, ex)

    step, step_inject = stepper(CONFIG), stepper(SATCLIP_CONFIG)
    runs = (("serving forward", forward, 10),
            ("serving forward, int8 trunk", forward_int8, 10),
            ("train step, batch 16", step, 5),
            (f"train step, batch 16 of {T512_TILE}^2 tiles ({T512_SIDE}^2)", s2_stepper(), 3),
            ("serving forward, inject", forward_inject, 10),
            ("train step, inject, batch 8", step_inject, 5),
            ("unet_256 serving forward, 4 x 512^2", forward_unet, 10),
            ("unet_256 train step, batch 16", unet_stepper(), 5),
            ("pix2pix (unet_256, batch norm) train step, batch 16",
             unet_stepper(norm="batch", no_dropout=False, gan_mode="vanilla"), 5))
    # all event timings first: once the profiler has attached, every
    # launch costs the host more, and the step is close to host-bound
    for what, fn, iters in runs:
        ms, plain_ms = compare_ms(fn, plain(fn), iters=iters)
        # how much of that is the host's: the same with the calls queued ahead
        ahead = time_ms(fn, iters, run_ahead=True)
        log("profile", f"{what}, CUDA events before the profiler: kernels "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms; with the card's head start "
            f"{ahead:.3f} ms")
    # the head's backward: tanh' on the saved output, then cuDNN's dgrad and
    # wgrad and the bias sum; the profile's groups cannot tell its cuDNN
    # kernels from the other convs'
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((1, 64, 7, 7), device=dev, generator=g) / 56.0
    b = torch.full((1,), 0.1, device=dev)
    for n, side in ((TRAIN_BATCH, TRAIN_SIDE), (SATCLIP_BATCH, TRAIN_SIDE),
                    (TRAIN_BATCH, T512_SIDE)):
        xh = torch.randn((n, side + 6, side + 6, 64), device=dev,
                         generator=g).bfloat16()
        y = head_conv_cuda(xh, w, b)
        ct = torch.randn(y.shape, device=dev, generator=g).bfloat16()
        ms = time_ms(lambda: head_conv_bwd(xh, w, y, ct), iters=10, run_ahead=True)
        fwd = time_ms(lambda: head_conv_cuda(xh, w, b), iters=10, run_ahead=True)
        log("profile", f"head backward (tanh', cuDNN dgrad + wgrad, bias sum) on "
            f"{tuple(xh.shape)}: {ms:.4f} ms; its forward, kernel C: {fwd:.4f} ms")
        del xh, y, ct
    pretrain = pretrain_stepper()
    rounds = [time_ms(pretrain, iters=5, warmup=1) for _ in range(3)]
    log("profile", f"SatCLIP pretrain step (full width, batch {PRETRAIN_BATCH}, f32, "
        f"cuDNN in TF32), CUDA events before the profiler: "
        f"{', '.join(f'{ms:.3f}' for ms in rounds)} ms")
    for what, fn, iters in runs:
        profile_window(f"{what}, kernels", fn, 5)
        profile_window(f"{what}, plain route", plain(fn), 5)
    profile_window(f"SatCLIP pretrain step, full width, batch {PRETRAIN_BATCH}",
                   pretrain, 5)


def phase_sweep() -> None:
    """``python3 chip_smoke.py --sweep``: kernels B and B4 in bf16 at every
    main-path shape under every launch plan they take (resident with each
    cluster size that fits, 256 and 512 threads; streaming), each held against the chosen plan's result and timed over
    rotated inputs."""
    from nirgan_tpu_torch.ops.instance_norm import (
        _launch,
        _launch_bwd,
        instance_norm_cuda,
        launch_plan,
        resident_plans,
        streaming_plan,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    serving_shapes, train_shapes, satclip_shapes = norm_shapes()
    for shape in serving_shapes + train_shapes + satclip_shapes:
        b, h, w, c = shape
        xb = (torch.randn(shape, device="cuda", generator=g) * 3.0 + 1.5).bfloat16()
        gb = torch.randn(shape, device="cuda", generator=g).bfloat16()
        _, stats = instance_norm_cuda(xb, relu=True, return_stats=True)
        sets = rotation(xb, gb)
        for backward in (False,) if shape in serving_shapes else (False, True):
            chosen = launch_plan(b, h * w, c, 2, backward)
            plans = [p._replace(threads=t)
                     for p in resident_plans(h * w, c, 2, backward)
                     for t in (256, 512)] + [streaming_plan(b, h * w, c, 2)]

            def run(x, dy, plan):
                if backward:
                    return _launch_bwd(x, dy, stats, True, plan=plan)
                return _launch(x, 1e-5, True, None, plan=plan)[0]

            ref = run(xb, gb, chosen).float()
            moved = nbytes(xb) * (3 if backward else 2)
            for plan in plans:
                err = float((run(xb, gb, plan).float() - ref).abs().max())
                ms = time_ms(rotating(lambda x, dy: run(x, dy, plan), sets),
                             iters=10, run_ahead=True)
                log("sweep", f"{'B4' if backward else 'B '} {shape} {plan.regime} "
                    f"cluster {plan.cluster} threads "
                    f"{plan.threads} smem {plan.smem_bytes}: {ms:.4f} ms "
                    f"({moved / PEAK_BYTES_PER_S * 1e5 / ms:.0f}% of the bound), "
                    f"max|diff| to the chosen plan {err:.3e}"
                    f"{'  <- chosen' if plan == chosen else ''}")
        del sets, xb, gb
        torch.cuda.empty_cache()


# device_launches: the host's sleep at each end of the profiler's window,
# and the windows a count may take where the profiler recorded no kernel
PROFILE_MARGIN_S = 0.01
PROFILE_ATTEMPTS = 5


def device_launches(fn, margin_s: float = PROFILE_MARGIN_S) -> int:
    """The kernels and device copies that one call of ``fn`` runs on the
    card, counted by ``torch.profiler``.  The call sits ``margin_s`` inside
    each end of the profiler's window: with no margin, about one window in
    200 recorded no kernel of a call of B (``--phase profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation and ev.device_time_total)


def alone_profiler(rounds: int = 250) -> None:
    """``--phase profiler``: the windows in which ``device_launches``
    recorded no kernel of one call of B, with its margin and without one,
    over ``rounds`` rounds of three of ``phase_norm_launches``' shapes, in
    a fresh process and after a window of 20,000 kernels."""
    from torch.profiler import ProfilerActivity, profile

    from nirgan_tpu_torch.ops.instance_norm import instance_norm_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED)
    calls = []
    for shape in ((16, 69, 69, 256), (4, 133, 133, 256), (16, 8, 8, 512)):
        x = (torch.randn(shape, device="cuda", generator=g) * 3.0 + 1.5).bfloat16()
        calls.append(lambda x=x: instance_norm_cuda(x, relu=True))
    for stage in ("fresh", "after a window of 20,000 kernels"):
        if stage != "fresh":
            y = torch.zeros(1024, device="cuda")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20000):
                    y.add_(1.0)
                torch.cuda.synchronize()
            prof.key_averages()
        lost = {0.0: 0, PROFILE_MARGIN_S: 0}
        for _ in range(rounds):
            for call in calls:
                for margin in lost:
                    lost[margin] += device_launches(call, margin) == 0
        for margin, n in lost.items():
            log("profiler", f"{stage}, margin {margin * 1e3:g} ms: no kernel recorded "
                f"in {n} of {rounds * len(calls)} windows")


def plan_entries(node):
    """Every dict under ``node`` that states a launch plan."""
    if isinstance(node, dict):
        if "regime" in node:
            yield node
        node = list(node.values())
    if isinstance(node, list):
        for child in node:
            yield from plan_entries(child)


def phase_norm_launches() -> None:
    """Counts what one call of B and of B4 launches on the card at every
    shape that ``phase_norms`` timed, writes it into the entries as
    ``cuda_launches`` and holds it to the regime: one launch where the plan
    is resident, two where it streams."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_bwd_cuda,
        instance_norm_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    counted: dict = {}
    for name, backward in (("instance_norm", False), ("instance_norm_bwd", True)):
        for e in plan_entries(RESULTS[name]):
            key = (backward, e["shape"], e["relu"], e.get("skip", False))
            if key not in counted:
                shape = ast.literal_eval(e["shape"])
                xb, rb, gb = ((torch.randn(shape, device="cuda", generator=g) * 3.0
                               + 1.5).bfloat16() for _ in range(3))
                if backward:
                    _, stats = instance_norm_cuda(xb, relu=e["relu"],
                                                  return_stats=True)

                    def call():
                        return instance_norm_bwd_cuda(xb, gb, stats, e["relu"])
                else:
                    def call():
                        return instance_norm_cuda(
                            xb, relu=e["relu"], residual=rb if e["skip"] else None)
                # a call launches a kernel or raises, so a count of 0 is a
                # trace the profiler lost (seen in up to 3 windows in a row
                # without the window's margins): count that call again
                for _ in range(PROFILE_ATTEMPTS):
                    counted[key] = device_launches(call)
                    if counted[key]:
                        break
                    log("launches", f"{name} {e['shape']}: the profiler recorded no "
                        "kernel of the call; counting again")
                log("launches", f"{name} {e['shape']} relu={e['relu']} "
                    f"skip={e.get('skip', False)}: {counted[key]} on the card a "
                    f"call ({e['regime']})")
            e["cuda_launches"] = counted[key]
            if counted[key] != (1 if e["regime"] == "resident" else 2):
                raise AssertionError(f"{name} {e['shape']}: {counted[key]} launches "
                                     f"a call in the {e['regime']} regime")


# ------------------------------------------------------------------ export
# the exported serving programs: (tag, config, int8 trunk)
EXPORTS = (("bf16", CONFIG, False), ("inject", SATCLIP_CONFIG, False),
           ("int8", CONFIG, True))
_FLOAT_FORWARD = {**EVAL_LAUNCHES, "int8_conv": 0, "int8_norm": 0}
# every kernel's launches in one exported forward: the int8 trunk's 18
# blocks' norms are E's, not B's
EXPORT_KERNELS = {"bf16": _FLOAT_FORWARD, "inject": _FLOAT_FORWARD,
                  "int8": {**_FLOAT_FORWARD, "trunk_conv": 0,
                           "instance_norm": EVAL_LAUNCHES["instance_norm"] - 18,
                           **INT8_FORWARD}}
# a process that loads each artifact with ``nirgan_tpu_torch.ops`` and the
# export module only, runs it on the card and counts its launches; argv:
# the directory of the artifacts (<tag>.pt2) and their inputs (<tag>.in.pt)
EXPORT_RUNNER = r"""
import json, os, sys
import torch
from nirgan_tpu_torch.inference.export import load_exported, run_exported
from nirgan_tpu_torch.ops import convt_bwd, head_conv, instance_norm, int8_trunk, trunk_conv

KERNELS = {"trunk_conv": trunk_conv.trunk_conv_cuda,
           "instance_norm": instance_norm.instance_norm_cuda,
           "instance_norm_bwd": instance_norm.instance_norm_bwd_cuda,
           "head_conv": head_conv.head_conv_cuda,
           "convt_bwd": convt_bwd.convt_k3s2_bwd_cuda,
           "int8_conv": int8_trunk.conv_moments_cuda,
           "int8_norm": int8_trunk.norm_quant_cuda}
folder, report = sys.argv[1], {}
for tag in sys.argv[2:]:
    with open(os.path.join(folder, tag + ".pt2"), "rb") as f:
        exported = load_exported(f.read())
    a = torch.load(os.path.join(folder, tag + ".in.pt"), map_location="cuda")
    for fn in KERNELS.values():
        fn.launches = 0
    y = run_exported(exported, a["params"], a["rgb"], a["embeds"], a["trunk_q"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    torch.save(y.cpu(), os.path.join(folder, tag + ".out.pt"))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        exported.call(a["params"], a["rgb"], a["embeds"], a["trunk_q"])
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        exported.call(a["params"], a["rgb"], a["embeds"], a["trunk_q"])
    end.record()
    end.synchronize()
    report[tag] = {"launches": launches, "ms": start.elapsed_time(end) / 10}
report["modules"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "nirgan_tpu")
                           or m.startswith(("nirgan_tpu_torch.models", "nirgan_tpu_torch.tasks",
                                            "nirgan_tpu_torch.config")))
print(json.dumps(report))
"""


def all_kernel_counts() -> dict:
    return {**counts(), **int8_counts()}


def op_host_us() -> dict:
    """Host microseconds a call of the instance norm at a tiny shape (1, 4,
    4, 32) bf16 on the card, the same implementation reached four ways: the
    routed call itself (no dispatcher); the port's operator
    (``torch.library.Library``, its gradient a lean ``Autograd`` kernel,
    ``ops/_registry.py``); the same schema with its gradient through
    ``torch.library.register_autograd``; and through
    ``torch.library.custom_op``.  Each without and with autograd recording
    (x requiring grad), in turns, forth and back, 2000 calls each after a
    warm-up; the card's kernel takes a few microseconds, so the host bounds
    the loop."""
    from nirgan_tpu_torch.ops import instance_norm as inm

    schema = "(Tensor x, Tensor? residual, float eps, bool relu) -> (Tensor, Tensor)"
    lib = torch.library.Library("nirgan_probe", "DEF")
    lib.define("instance_norm" + schema)
    for key in ("CPU", "CUDA"):
        lib.impl("instance_norm", inm._routed, key)
    torch.library.register_fake("nirgan_probe::instance_norm", inm._fake, lib=lib)
    torch.library.register_autograd("nirgan_probe::instance_norm", inm._backward,
                                    setup_context=inm._setup, lib=lib)
    probe = torch.library.custom_op("nirgan_probe::instance_norm_op", inm._routed,
                                    mutates_args=(), schema=schema)
    probe.register_fake(inm._fake)
    probe.register_autograd(inm._backward, setup_context=inm._setup)
    x = torch.randn((1, 4, 4, 32), device="cuda", dtype=torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    ways = {"routed call": lambda t: inm._routed(t, None, 1e-5, False),
            "port operator": lambda t: torch.ops.nirgan.instance_norm(t, None, 1e-5, False),
            "register_autograd": lambda t: torch.ops.nirgan_probe.instance_norm(
                t, None, 1e-5, False),
            "custom_op": lambda t: probe(t, None, 1e-5, False)}

    def us(fn, t, n=2000):
        for _ in range(50):
            fn(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    for grad, t in (("no_grad", x), ("grad", xg)):
        with torch.set_grad_enabled(grad == "grad"):
            forth = {k: us(fn, t) for k, fn in ways.items()}
            back = {k: us(ways[k], t) for k in reversed(ways)}
        out[grad] = {k: (forth[k] + back[k]) / 2 for k in ways}
    del lib
    return out


def phase_export(tmp: str) -> dict:
    """``nirgan_tpu_torch.inference.export`` on the card: the bf16 plain,
    inject and int8 serving programs of 4 x 512^2 (reflect-padded to 532^2
    inside) exported with ``torch.export``; in this process each artifact
    against the live ``g_apply`` (bit for bit, the same launches a forward,
    no weight layout made anew by a second call, CUDA-event ms of both in
    turns); then all three loaded and run in a
    fresh process that imports ``nirgan_tpu_torch.ops`` and the export
    module only (no jax, no ``nirgan_tpu``, no model, task or config code):
    bit for bit and the same launches again.  Last, the operators' host cost
    a call (``op_host_us``).  Returns the launches of one exported forward
    by artifact."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference.export import export_generator, load_exported
    from nirgan_tpu_torch.ops import _pack
    from nirgan_tpu_torch.tasks import Px2PxTask

    seeded = torch.Generator().manual_seed(SEED)
    rgb = (torch.rand((BATCH, 3, TILE, TILE), generator=seeded) * 0.3).cuda()
    folder = os.path.join(tmp, "export")
    os.makedirs(folder, exist_ok=True)
    live_out, per_forward = {}, {}
    for tag, config, int8 in EXPORTS:
        task = Px2PxTask(load_config(config), device="cuda", seed=SEED)
        embeds = torch.zeros((BATCH, 256), device="cuda")
        if task.inject:
            embeds = torch.randn((BATCH, 256), generator=seeded).cuda()
            with torch.no_grad():
                task.netG.scale_param.fill_(0.5)  # so a fault in the plane shows
        x = rgb.permute(0, 2, 3, 1).to(task.compute_dtype)
        tq = task.build_trunk_q(x) if int8 else None
        params = task.netG.state_dict()
        t0 = time.perf_counter()
        blob = export_generator(task, params, TILE, BATCH, trunk_q=tq)
        export_s = time.perf_counter() - t0
        exported = load_exported(blob)

        def live():
            return task.g_apply(rgb.permute(0, 2, 3, 1).to(task.compute_dtype),
                                embeds if task.inject else None, tq).float().permute(0, 3, 1, 2)

        def run():
            return exported.call(params, rgb, embeds, tq)

        with torch.no_grad():
            reset_counts()
            want = live()
            torch.cuda.synchronize()
            live_launches = all_kernel_counts()
            reset_counts()
            got = run()
            torch.cuda.synchronize()
            launches = all_kernel_counts()
            same = torch.equal(got, want)
            # the kernels' weight layouts (A's and C's; D's pack) kept
            # across calls of the artifact: none made anew by another call
            kept = {k: id(v[2]) for k, v in _pack._LAID_OUT.items()}
            run()
            relaid = sum(kept.get(k) != id(v[2]) for k, v in _pack._LAID_OUT.items())
            ms_live, ms_exported = compare_ms(live, run, iters=20)
        nodes = {}
        for node in exported.program.graph.nodes:
            if node.op == "call_function" and str(node.target).startswith("nirgan."):
                name = str(node.target).split(".")[1]
                nodes[name] = nodes.get(name, 0) + 1
        log("export", f"{tag}: exported in {export_s:.1f} s ({len(blob) / 2**20:.1f} MiB); "
            f"the program's operators {nodes}; launches a forward exported {launches}, "
            f"live {live_launches} (want {EXPORT_KERNELS[tag]}); exported vs live "
            f"bit for bit: {same}; weight layouts made anew by a second exported "
            f"forward: {relaid} (must be 0); forward of {BATCH} x {TILE}^2 (CUDA "
            f"events) exported "
            f"{ms_exported:.3f} ms, live {ms_live:.3f} ms ({ms_exported / ms_live:.4f}x)")
        if not (same and relaid == 0 and launches == live_launches == EXPORT_KERNELS[tag]
                and tuple(got.shape) == (BATCH, 1, TILE, TILE)):
            raise AssertionError(f"export {tag}: {same}, {relaid}, {launches}, "
                                 f"{live_launches}")
        per_forward[tag] = {"launches": launches, "ms": ms_exported, "live_ms": ms_live,
                            "export_s": export_s}
        live_out[tag] = want.cpu()
        with open(os.path.join(folder, f"{tag}.pt2"), "wb") as f:
            f.write(blob)
        torch.save({"params": params, "rgb": rgb, "embeds": embeds, "trunk_q": tq},
                   os.path.join(folder, f"{tag}.in.pt"))
        del task, exported, params, tq

    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run([sys.executable, "-c", EXPORT_RUNNER, folder,
                          *(tag for tag, _, _ in EXPORTS)], capture_output=True, text=True,
                         timeout=600, env=env)
    if res.returncode != 0:
        raise AssertionError(f"the artifacts' own process failed:\n{res.stderr[-4000:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    for tag, _, _ in EXPORTS:
        got = torch.load(os.path.join(folder, f"{tag}.out.pt"))
        same = torch.equal(got, live_out[tag])
        log("export", f"{tag} in a process of its own: bit for bit with the live "
            f"forward: {same}; launches {report[tag]['launches']}; forward "
            f"{report[tag]['ms']:.3f} ms")
        if not (same and report[tag]["launches"] == per_forward[tag]["launches"]):
            raise AssertionError(f"export {tag} in its own process: {same}, {report[tag]}")
        per_forward[tag]["process_ms"] = report[tag]["ms"]
    log("export", f"modules of the package, jax or nirgan_tpu in that process: "
        f"{report['modules']} (must be none)")
    if report["modules"]:
        raise AssertionError(f"loading an artifact imported {report['modules']}")
    host = op_host_us()
    log("export", f"host us a call of the instance norm at (1, 4, 4, 32) bf16: {host}")
    per_forward["host_us"] = host
    return per_forward


def phase_times() -> dict:
    """The times that hold a commit against another on one card
    (``--times ROOT`` runs them on the package at ROOT): kernel B at (16,
    69^2, 256) and (16, 276^2, 64), bf16 with the ReLU, over rotated inputs;
    the bf16 serving forward of 4 x 532^2 and the batch-16 fused step of
    ``config_px2px.yaml`` (CUDA events, in turns, the median of three
    rounds); the host's microseconds a call of the public instance norm at
    (1, 4, 4, 32) bf16 with autograd recording, as the step calls it;
    ``int8_times``; last, the int8 forward under the profiler."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.ops.instance_norm import instance_norm, instance_norm_cuda
    from nirgan_tpu_torch.tasks import Px2PxTask

    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in ((TRAIN_BATCH, 69, 69, 256), (TRAIN_BATCH, TRAIN_SIDE, TRAIN_SIDE, 64)):
        xb = torch.randn(shape, generator=g, device="cuda").bfloat16()
        sets = rotation(xb)
        ms = [time_ms(rotating(lambda x: instance_norm_cuda(x, relu=True), sets),
                      iters=10, run_ahead=True) for _ in range(3)]
        out[f"B {shape}"] = sorted(ms)[1]
    cfg = load_config(CONFIG)
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    x = (torch.rand((BATCH, TILE, TILE, 3), generator=torch.Generator().manual_seed(1))
         * 0.3).cuda().bfloat16()
    state, ex = task.init_state(), task.extract_batch(first_batch(cfg))

    def forward():
        with torch.inference_mode():
            task.g_apply(x)

    rounds = [compare_ms(forward, lambda: task.train_step(state, ex), iters=10)
              for _ in range(3)]
    out["forward"] = sorted(r[0] for r in rounds)[1]
    out["step"] = sorted(r[1] for r in rounds)[1]
    xs = torch.randn((1, 4, 4, 32), device="cuda", dtype=torch.bfloat16,
                     requires_grad=True)
    for _ in range(50):
        instance_norm(xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        instance_norm(xs)
    torch.cuda.synchronize()
    out["instance_norm host us"] = (time.perf_counter() - t0) / 2000 * 1e6
    del task, state, ex
    forward_int8 = int8_times(g, out)
    import nirgan_tpu_torch

    log("times", f"{os.path.dirname(os.path.dirname(nirgan_tpu_torch.__file__))}: "
        + json.dumps(out))
    # last: once the profiler has attached, every launch costs the host more
    out["int8 forward busy"] = profile_window("int8 serving forward, 4 x 532^2",
                                              forward_int8, 5)
    return out


def d_timed_shapes() -> tuple:
    """Kernel D's four timed gathers (border, stride, input shape): the
    serving trunk's reflect (4, 133^2, 256), stage 2's d1 at stride 2, and
    the VALID and STRIDE2_VALID slabs of shard 0 of the 2048^2 tile over two
    ranks; Cout 256."""
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    side = SPATIAL_SIDE + 2 * PAD
    lo, hi = row_ranges(side, 2)[0]
    rows = (hi - lo) // 4
    return (("reflect", 1, (BATCH, SIDE // 4, SIDE // 4, 256)),
            ("zero", 2, (BATCH, SIDE // 2, SIDE // 2, 128)),
            ("valid", 1, (1, rows + 2, side // 4 + 2, 256)),
            ("valid", 2, (1, 2 * rows + 1, side // 2 + 2, 128)))


def int8_times(g: torch.Generator, out: dict):
    """``phase_times``'s int8 part, into ``out``: kernel D at its four timed
    gathers, kernel A at its serving and train shapes and kernel E at
    ``e_calls``' shapes with a sha256 of its outputs (the median of three
    rounds of 10 calls after the card's head start), D right after E
    (``d_after_e``), and the int8
    serving forward of 4 x 532^2 (the plain generator, its trunk calibrated
    on the batch; CUDA events, the median of five rounds).  Returns the
    forward, for the profile."""
    from nirgan_tpu_torch.models import define_G
    from nirgan_tpu_torch.ops.int8_trunk import (
        calibrate_trunk,
        conv_moments_cuda,
        norm_quant_cuda,
        quantize_trunk,
    )
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda

    def median_ms(fn):
        return sorted(time_ms(fn, iters=10, run_ahead=True) for _ in range(3))[1]

    for border, stride, shape in d_timed_shapes():
        x8 = torch.randint(-127, 128, shape, device="cuda", generator=g, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (256, shape[3], 3, 3), device="cuda", generator=g,
                           dtype=torch.int8)
        out[f"D {border} s{stride} {shape}"] = median_ms(
            lambda: conv_moments_cuda(x8, w8, border, stride))
        del x8, w8
    for shape in ((TRAIN_BATCH, 69, 69, 256), (BATCH, SIDE // 4, SIDE // 4, 256),
                  (TRAIN_BATCH, T512_SIDE // 4, T512_SIDE // 4, 256)):
        xb = torch.randn(shape, device="cuda", generator=g).bfloat16()
        wf = torch.randn((256, 256, 3, 3), device="cuda", generator=g) / 48
        out[f"A {shape}"] = median_ms(lambda: trunk_conv_cuda(xb, wf))
        del xb, wf
    # E at e_calls' shapes on inputs of their own seed, so that two
    # checkouts' outputs compare by their digests
    calls = e_calls(torch.Generator(device="cuda").manual_seed(SEED))
    for tag, (args, _) in calls.items():
        got = norm_quant_cuda(*args)
        out[f"E {tag} sha256"] = hashlib.sha256(b"".join(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for t in (got if isinstance(got, tuple) else (got,)) if t is not None)).hexdigest()
        out[f"E {tag}"] = median_ms(lambda: norm_quant_cuda(*args))
        del got
    out.update({f"D after {k}": v for k, v in d_after_e(g, calls).items()})
    del calls
    dev = torch.device("cuda")
    G = define_G(3, 1, 64, "resnet_9blocks", "instance", compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    x = (torch.rand((BATCH, SIDE, SIDE, 3), generator=torch.Generator().manual_seed(1))
         * 0.3).to(dev)
    with torch.inference_mode():
        calib = calibrate_trunk(G, x)
    with torch.no_grad():
        pack = quantize_trunk(G.state_dict(), G.n_blocks, calib)

    def forward_int8():
        with torch.inference_mode():
            G(x, trunk_q=pack)

    out["int8 forward"] = sorted(time_ms(forward_int8, iters=10) for _ in range(5))[2]
    return forward_int8


# ---------------------------------------------------------- kernel D's split
# ``--split ROOT``: kernel D's wgmma kernel from the sources at ROOT (this
# checkout, or a parent's unpacked beside it), built again with parts of its
# work cut out by text patches at build time, each variant timed at D's four
# timed gathers in turns.  A variant's macro is 1 where the part runs.  The
# parts a source form has: the epilogue (V_EPI; with it cut, its
# accumulators still go to one xor so that ptxas keeps the products), the
# products (V_MMA), the ring's fill (V_FILL: the gather and the weight copy),
# the moments and the stores inside the epilogue (V_MOM, V_ST), the conv
# kernel itself (V_MAIN: without it, the moments launch alone).
_SINK = ("{\n int x = 0;\n#pragma unroll\n for (int r = 0; r < R_; ++r)\n#pragma unroll\n"
         " for (int i = 0; i < I_; ++i) x ^= SRC_;\n"
         " if (x == 0x7fffffff) out[0] = __float2bfloat16(1.f);\n}\n")
SPLIT_PATCHES = {
    # the form of PRs 6-16: igemm_wgmma_kernel<N, S8> with s8_epilogue<N>
    "tile epilogue": [
        ("        s8_epilogue<N>(d, tile, m0, M, g.Ho * g.Wo, wg, warp, lane, red, out,\n"
         "                       part);",
         "        if (V_EPI) s8_epilogue<N>(d, tile, m0, M, g.Ho * g.Wo, wg, warp, lane, red,\n"
         "                                  out, part);\n        else "
         + _SINK.replace("R_", "T::R").replace("I_", "N / 2").replace("SRC_", "d[r][i]")),
        ("            if constexpr (S8)\n              wgmma_k32_s8<N>(d[r], da, db, (it | k) != 0);",
         "            if constexpr (S8) {\n              if (V_MMA) wgmma_k32_s8<N>(d[r], da, db, (it | k) != 0);\n"
         "            }"),
        ("        if (t == 0) {\n          mbar_arrive_expect_tx(full, T::B_BYTES);",
         "        if (t == 0 && !(S8 && !V_FILL)) {\n          mbar_arrive_expect_tx(full, T::B_BYTES);"),
        ("          cp_async16(a_s + swizzled(row, chunk),",
         "          if (!S8 || V_FILL) cp_async16(a_s + swizzled(row, chunk),"),
        ("        cp_async_arrive(full);",
         "        if (S8 && !V_FILL && t == 0) mbar_arrive(full);\n        cp_async_arrive(full);"),
    ],
    # this PR's form: igemm_s8_kernel<N> walking runs of grains
    "grain runs": [
        ("  constexpr int COLS = JB * 8;\n",
         "  constexpr int COLS = JB * 8;\n  if (!V_EPI) {\n"
         + _SINK.replace("R_", "U").replace("I_", "JB * 4").replace("SRC_", "d[r][i]")
         + "    return;\n  }\n"),
        ("    for (int pass = 0; pass < 2; ++pass) {", "    for (int pass = 0; pass < 2 * V_MOM; ++pass) {"),
        ("  // the bf16 rows, 64 columns at a time",
         "  if (!V_ST) return;\n  // the bf16 rows, 64 columns at a time"),
        ("  grain_run(blockIdx.x, runs, g0, g1);\n",
         "  grain_run(blockIdx.x, runs, g0, g1);\n  if (!V_MAIN) return;\n"),
    ],
}
# variant: the macros it sets to 0 (every other macro is 1)
SPLIT_VARIANTS = {
    "tile epilogue": {"whole": (), "no epilogue": ("V_EPI",), "no products": ("V_MMA",),
                      "the ring alone": ("V_EPI", "V_MMA"), "no fill": ("V_FILL",),
                      "the barriers alone": ("V_EPI", "V_MMA", "V_FILL")},
    "grain runs": {"whole": (), "no epilogue": ("V_EPI",), "no moments": ("V_MOM",),
                   "no stores": ("V_ST",), "the moments launch alone": ("V_MAIN",)},
}
SPLIT_MACROS = ("V_EPI", "V_MMA", "V_FILL", "V_MOM", "V_ST", "V_MAIN")


class SplitPatchError(RuntimeError):
    """A ``--split`` patch that does not apply exactly once to its kernel's
    source: the patches follow the source's text, so an edit of the kernel
    needs its patches edited with it."""


def patched(text: str, patches: list, what: str) -> str:
    """``text`` with each (old, new) of ``patches`` applied, each old found
    in it exactly once, else ``SplitPatchError``."""
    for old, new in patches:
        if text.count(old) != 1:
            raise SplitPatchError(f"{what}: {text.count(old)} matches of the patch {old[:80]!r}")
        text = text.replace(old, new)
    return text


def split_build(sources: dict, others: tuple = ()) -> tuple[dict, dict]:
    """Compile each variant's source text (name -> text) with the library's
    flags, all at once, each linked with the ``others`` (csrc names compiled
    as they are) into a library of its own.  Returns (name -> the loaded
    ``ctypes.CDLL``, name -> ptxas's report)."""
    import ctypes

    from nirgan_tpu_torch.ops import _lib

    libs, reports = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_") as tmp:
        shutil.copytree(_lib.CSRC, os.path.join(tmp, "csrc"))
        procs, shared = [], []
        for other in others:
            shared.append(os.path.join(tmp, other + ".o"))
            procs.append(subprocess.Popen(
                [_lib.nvcc(), *_lib.NVCC_FLAGS, "-c", "-o", shared[-1],
                 os.path.join(tmp, "csrc", other)],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
        objs, logs = {}, {}
        for i, (name, text) in enumerate(sources.items()):
            src = os.path.join(tmp, "csrc", f"split_{i}.cu")
            with open(src, "w") as f:
                f.write(text)
            objs[name], logs[name] = os.path.join(tmp, f"split_{i}.o"), os.path.join(tmp, f"{i}.txt")
            with open(logs[name], "w") as sink:
                procs.append(subprocess.Popen([_lib.nvcc(), *_lib.NVCC_FLAGS, "-c", "-o",
                                               objs[name], src],
                                              stdout=sink, stderr=subprocess.STDOUT))
        if any(p.wait() for p in procs):
            raise RuntimeError("a variant did not build: "
                               + " ".join(open(f).read()[-2000:] for f in logs.values()))
        for name, obj in objs.items():
            so = os.path.join(tmp, f"{len(libs)}.so")
            subprocess.run([_lib.nvcc(), *_lib.ARCH, "-shared", "-o", so, obj, *shared],
                           check=True)
            lib = ctypes.CDLL(so)
            for entry_name, args in _lib._SIGNATURES.items():
                if hasattr(lib, entry_name):
                    getattr(lib, entry_name).argtypes = list(args)
                    getattr(lib, entry_name).restype = ctypes.c_int
            libs[name] = lib
            reports[name] = open(logs[name]).read()
    return libs, reports


def through(lib, fn, *args, **kw):
    """``fn`` of the package's kernel wrappers with ``lib`` as the kernel
    library."""
    from nirgan_tpu_torch.ops import _lib

    real = _lib.library
    _lib.library = lambda: lib
    try:
        return fn(*args, **kw)
    finally:
        _lib.library = real


def split_d() -> dict:
    """Kernel D's part of ``--split``: its wgmma kernel built from ROOT's
    sources once a variant of ``SPLIT_VARIANTS`` (the form whose patches all
    apply), each with the wrapper of ROOT at the gathers of
    ``d_timed_shapes``, timed in turns (forth and back, 20 calls after the
    card's head start); the whole variant first held equal to the library's
    result."""
    from nirgan_tpu_torch.ops import _lib, int8_trunk

    engine = (_lib.CSRC / "igemm_wgmma.cu").read_text()
    form = next((f for f, patches in SPLIT_PATCHES.items()
                 if all(engine.count(a) == 1 for a, _ in patches)), None)
    if form is None:
        raise SplitPatchError("igemm_wgmma.cu: no form of SPLIT_PATCHES applies")
    engine = patched(engine, SPLIT_PATCHES[form], "igemm_wgmma.cu")
    libs, _ = split_build(
        {name: "".join(f"#define {m} {0 if m in cut else 1}\n" for m in SPLIT_MACROS) + engine
         for name, cut in SPLIT_VARIANTS[form].items()}, ("int8_conv.cu",))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"form": form}
    for border, stride, shape in d_timed_shapes():
        x8 = torch.randint(-127, 128, shape, device="cuda", generator=g, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (256, shape[3], 3, 3), device="cuda", generator=g,
                           dtype=torch.int8)
        args = (x8, w8, True, border, stride)
        ref, got = int8_trunk._launch(*args), through(libs["whole"], int8_trunk._launch, *args)
        if not (torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])):
            raise AssertionError(f"--split: the whole variant differs at {shape}")
        ms = compare_ms(*[lambda lib=lib: through(lib, int8_trunk._launch, *args)
                          for lib in libs.values()], run_ahead=True)
        out[f"{border} s{stride} {shape}"] = dict(zip(libs, ms))
        del x8, w8, ref, got
    log("split", json.dumps(out))
    return out


# ---------------------------------------------------------- kernel E's split
# ``--split ROOT E``: kernel E (``int8_norm.cu``) from the sources at ROOT,
# built again with parts of its work cut out by text patches, each variant
# timed in its four modes at the serving trunk's shape and in mode 1 with a
# shard's count, in turns.  The patches follow this form of the kernel (a
# block a run of one image's pixels, passes of LOAD_BYTES, the first ones
# staged in shared memory during the prologue, the reciprocal and its
# guard); a source they do not apply to raises ``SplitPatchError``.  The
# macros: V_ARITH 0 keeps the loads and the stores and drops the arithmetic
# (q the low bytes of the loaded words: the card's streaming floor for E's
# bytes and its access pattern); V_PRO 0 drops the prologue (mean 0, rstd
# 1, scale 1: no moments read, no barrier); V_DIV 0 drops the guard (the
# bare product by the reciprocal: timed, and held to round otherwise than
# the library on ``e_near_halves``); V_BYTES the bytes a thread loads for a
# pass; V_PIPE 0 loads the next pass after this one's arithmetic; V_STAGED
# the passes staged in shared memory while the prologue runs, in every
# mode (-1: the source's choice by mode); V_MINB the blocks an SM that
# ``__launch_bounds__`` asks of ptxas; V_CARVE the shared memory's share of
# the SM's L1 and shared memory that E asks for, in percent (-1: none
# asked).
_E_COPY_RAW = r"""
// the split's copy: the loaded words stored again, none of the arithmetic
template <typename S, typename T, int MODE>
__device__ __forceinline__ void copy_raw(const Raw8<S>& s8, const Raw8<T>& x8, T* out,
                                         int8_t* q) {
  uint4 a = s8.w[0];
  if (sizeof(S) == 4) { a.x ^= s8.w[sizeof(S) / 2 - 1].x; a.y ^= s8.w[sizeof(S) / 2 - 1].y; }
  if (MODE == 2 || MODE == 3) {
    uint4* o = reinterpret_cast<uint4*>(out);
    uint4 v = a;
    if (MODE == 2) { v = x8.w[0]; v.x ^= a.x; }
    o[0] = v;
    if (sizeof(T) == 4) {
      if (MODE == 2) { v = x8.w[sizeof(T) / 2 - 1]; v.y ^= a.y; }
      o[1] = v;
    }
  }
  if (MODE != 2 || q) {
    uint2 b;
    b.x = __byte_perm(a.x, a.y, 0x6420);
    b.y = __byte_perm(a.z, a.w, 0x6420);
    *reinterpret_cast<uint2*>(q) = b;
  }
}
"""
E_SPLIT_PATCHES = [
        ("constexpr int LOAD_BYTES = 64;", "constexpr int LOAD_BYTES = V_BYTES;"),
        ("__global__ void __launch_bounds__(THREADS)\nint8_norm_kernel(",
         "__global__ void __launch_bounds__(THREADS, V_MINB)\nint8_norm_kernel("),
        ("template <typename T, int MODE, bool DIVIDED, typename S>\n",
         _E_COPY_RAW + "\ntemplate <typename T, int MODE, bool DIVIDED, typename S>\n"),
        ("  float v[8];\n  unpack(a, v);\n",
         "  if (!V_ARITH) {\n    copy_raw<S, T, MODE>(a, xs, out + off, q + off);\n    return;\n  }\n"
         "  float v[8];\n  unpack(a, v);\n"),
        ("  for (int c = threadIdx.x; c < C; c += blockDim.x) {\n    const float sc",
         "  for (int c = threadIdx.x; V_PRO && c < C; c += blockDim.x) {\n    const float sc"),
        ("  odd = __syncthreads_or(odd);", "  if (V_PRO) odd = __syncthreads_or(odd);"),
        ("    k.rcp[e] = rcp_s[c0 + e];\n    if (MODE != 0) {\n      k.mean[e] = mean_s[c0 + e];\n"
         "      k.rstd[e] = rstd_s[c0 + e];",
         "    k.rcp[e] = V_PRO ? rcp_s[c0 + e] : 1.f;\n    if (MODE != 0) {\n"
         "      k.mean[e] = V_PRO ? mean_s[c0 + e] : 0.f;\n"
         "      k.rstd[e] = V_PRO ? rstd_s[c0 + e] : 1.f;"),
        ("    if (!(half > __fmul_rn(fabsf(t), GUARD))) near |= 1u << e;",
         "    if (V_DIV && !(half > __fmul_rn(fabsf(t), GUARD))) near |= 1u << e;"),
        ("{ return mode == 3 ? 4 : 1; }", "{ return V_STAGED >= 0 ? V_STAGED : mode == 3 ? 4 : 1; }"),
        ("    fetch(a1, x1, p + step);\n    run(a0, x0, p);\n",
         "    if (V_PIPE) fetch(a1, x1, p + step);\n    run(a0, x0, p);\n"
         "    if (!V_PIPE) fetch(a1, x1, p + step);\n"),
        ("    fetch(a0, x0, p + step);\n    run(a1, x1, p);\n",
         "    if (V_PIPE) fetch(a0, x0, p + step);\n    run(a1, x1, p);\n"
         "    if (!V_PIPE) fetch(a0, x0, p + step);\n"),
        ("  static size_t allowed[MAX_DEVICES][8];\n",
         "  if (V_CARVE >= 0)\n"
         "    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, V_CARVE);\n"
         "  static size_t allowed[MAX_DEVICES][8];\n"),
]
E_SPLIT_DEFAULTS = {"V_ARITH": 1, "V_PRO": 1, "V_DIV": 1, "V_BYTES": 64, "V_STAGED": -1,
                    "V_PIPE": 1, "V_MINB": 1, "V_CARVE": -1}
# the variants that keep E's function, held bit for bit with the library
E_SPLIT_EXACT = ("whole", "a pass of 32 bytes", "a pass of 128 bytes", "one pass in flight",
                 "one pass staged", "two passes staged", "four passes staged", "no staging",
                 "3 blocks an SM", "carveout 0", "carveout 30", "carveout 100")
E_SPLIT_VARIANTS = {
    "whole": {}, "a pass of 32 bytes": {"V_BYTES": 32}, "a pass of 128 bytes": {"V_BYTES": 128},
    "one pass in flight": {"V_PIPE": 0}, "one pass staged": {"V_STAGED": 1},
    "two passes staged": {"V_STAGED": 2}, "four passes staged": {"V_STAGED": 4},
    "no staging": {"V_STAGED": 0}, "3 blocks an SM": {"V_MINB": 3},
    "carveout 0": {"V_CARVE": 0}, "carveout 30": {"V_CARVE": 30}, "carveout 100": {"V_CARVE": 100},
    "no prologue": {"V_PRO": 0},
    "no guard": {"V_DIV": 0}, "the copy and the prologue": {"V_ARITH": 0},
    "the copy alone": {"V_ARITH": 0, "V_PRO": 0}}


def e_patched(text: str) -> dict:
    """Each variant's source of ``int8_norm.cu``'s text."""
    text = patched(text, E_SPLIT_PATCHES, "int8_norm.cu")
    return {name: "".join(f"#define {m} {v}\n" for m, v in
                          {**E_SPLIT_DEFAULTS, **cut}.items()) + text
            for name, cut in E_SPLIT_VARIANTS.items()}


def e_registers(report: str) -> dict:
    """ptxas's registers of each E instance in a build's report, by
    "dtype mode", with its spill stores in bytes where it spills."""
    found, name, spill = {}, None, 0
    for line in report.splitlines():
        hit = re.search(r"int8_norm_kernelI(13__nv_bfloat16|f)Li(\d)E", line)
        if "Compiling entry function" in line:
            name = (f"{'bf16' if hit.group(1) != 'f' else 'f32'} mode {hit.group(2)}"
                    if hit else None)
            spill = 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            found[name] = f"{regs} (spills {spill} B)" if spill else regs
            name = None
    return found


def e_constants(g: torch.Generator, m: torch.Tensor) -> tuple:
    """E's per-channel constants of a calibrated trunk's size, for the
    moments m (B, 2, C): eps' = 1e-5 / k^2 with k about the folded weights'
    scale, scales that put the normalised values at +-40 quantisation steps
    or so."""
    c = m.shape[2]
    k = (torch.rand(c, device=m.device, generator=g) + 0.5) * m[:, 1].mean().sqrt() / 300
    return 1e-5 / k.square(), (torch.rand(c, device=m.device, generator=g) + 0.5) * 3.0 / 127


def e_calls(g: torch.Generator) -> dict:
    """E's timed calls, (tag -> (mode, the arguments of ``norm_quant_cuda``,
    the bytes that must move)): the four modes at the serving trunk's shape
    (4, 133^2, 256) on kernel D's accumulator and moments, with a bf16
    stream, and mode 1 at shard 0's (1, 259 x 517, 256) of the 2048^2 tile
    over two ranks with the tile's count."""
    from nirgan_tpu_torch.ops.int8_trunk import conv_moments_cuda
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    side = SPATIAL_SIDE + 2 * PAD
    lo, hi = row_ranges(side, 2)[0]
    calls = {}
    for shape, count in (((BATCH, SIDE // 4, SIDE // 4, 256), None),
                         ((1, (hi - lo) // 4 + 2, side // 4 + 2, 256), (side // 4) ** 2)):
        x8 = torch.randint(-127, 128, shape, device="cuda", generator=g, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (256, 256, 3, 3), device="cuda", generator=g,
                           dtype=torch.int8)
        hb, m = conv_moments_cuda(x8, w8, "reflect" if count is None else "valid")
        eps, s = e_constants(g, m)
        xb = (torch.randn(tuple(hb.shape), device="cuda", generator=g) * 2.0).bfloat16()
        tag = f"{tuple(hb.shape)}"
        if count is None:
            calls[f"mode 0 {tag}"] = ((0, xb, s), nbytes(xb) + xb.numel())
            calls[f"mode 1 {tag}"] = ((1, hb, s, m, eps), nbytes(hb, m) + hb.numel())
            calls[f"mode 2 {tag}"] = ((2, hb, s, m, eps, xb),
                                      nbytes(hb, m, xb, xb) + hb.numel())
            calls[f"mode 3 {tag}"] = ((3, hb, s, m, eps, None, torch.bfloat16),
                                      nbytes(hb, m, xb) + hb.numel())
        else:
            calls[f"mode 1 {tag} count {count}"] = ((1, hb, s, m, eps, None, None, count),
                                                    nbytes(hb, m) + hb.numel())
        del x8, w8
    return calls


def split_e() -> dict:
    """Kernel E's part of ``--split``: ``int8_norm.cu`` of ROOT built once a
    variant of ``E_SPLIT_VARIANTS``, each on its own plan (its occupancy)
    and timed through ROOT's wrapper at ``e_calls``' shapes in turns (forth
    and back, 20 calls after the card's head start); every variant of
    ``E_SPLIT_EXACT`` first held bit for bit with the library's result,
    there and on ``e_near_halves``, where "no guard" must differ; beside
    each variant its registers (ptxas) and blocks an SM (the occupancy
    query) by instance; last ``d_after_e`` with E's staged passes and its
    carveout varied."""
    from nirgan_tpu_torch.ops import _lib, int8_trunk

    libs, reports = split_build(e_patched((_lib.CSRC / "int8_norm.cu").read_text()))
    out = {"registers": {n: e_registers(r) for n, r in reports.items()},
           "blocks_per_sm": {n: {f"{'bf16' if code else 'f32'} mode {mode}":
                                 lib.nirgan_int8_norm_blocks_per_sm(0, mode, code, 256)
                                 for mode, code in ((0, 1), (0, 0), (1, 1), (2, 1), (2, 0),
                                                    (3, 1), (3, 0))}
                             for n, lib in libs.items()}}

    def runner(lib, args):
        # a variant on its own plan
        b, h, w, c = args[1].shape
        code = e_code(args)
        per_sm = lib.nirgan_int8_norm_blocks_per_sm(0, args[0], code, c)
        blocks = int8_trunk.norm_blocks(b, h * w, c, per_sm * int8_trunk.sm_count(0),
                                        int8_trunk.norm_pass(args[0], code))
        return lambda: through(lib, int8_trunk._launch_norm, *args, blocks=blocks)

    def held(tag, args, ref):
        for name in E_SPLIT_EXACT:
            got = runner(libs[name], args)()
            pairs = zip(ref, got) if isinstance(ref, tuple) else [(ref, got)]
            if not all(torch.equal(a, b) for a, b in pairs if a is not None):
                raise AssertionError(f"--split: E's variant {name!r} differs in {tag}")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        x, s = e_near_halves(g, dtype)
        ref = int8_trunk.norm_quant_cuda(0, x, s)
        bit_for_bit(ref, int8_trunk.quantize_plain(x, s), f"--split near half-integers {dtype}")
        held(f"near half-integers {dtype}", (0, x, s), ref)
        n = int((runner(libs["no guard"], (0, x, s))() != ref).sum())
        out[f"no guard, outputs that differ near half-integers {dtype}"] = n
        if not n:
            raise AssertionError(f"--split: without the guard E still equals the library "
                                 f"near half-integers ({dtype})")
    calls = e_calls(g)
    for tag, (args, moved) in calls.items():
        held(tag, args, int8_trunk.norm_quant_cuda(*args))
        ms = compare_ms(*[runner(lib, args) for lib in libs.values()], run_ahead=True)
        out[tag] = {**dict(zip(libs, ms)), "bound_ms": least_time(0, moved)[0]}
    out["D after"] = d_after_e(g, calls, {
        f"E mode {mode}, {name}": (libs[name], mode)
        for mode, names in ((1, ("four passes staged", "no staging")),
                            (2, ("two passes staged", "one pass staged", "no staging")))
        for name in names} | {
        f"E mode {mode}, {name}": (libs[name], mode)
        for mode in (1, 2) for name in ("carveout 0", "carveout 30", "carveout 100")}, runner)
    log("split", json.dumps(out))
    return out


def d_after(preds: dict, w8: torch.Tensor, rounds: int = 20) -> dict:
    """Kernel D's ms at the serving trunk's reflect gather right after each
    of ``preds`` (name -> a call that returns D's int8 input), as the int8
    forward runs it: the predecessor, then D on what it returned between
    CUDA events.  Each round queues every kind once behind a 2 ms spin of
    the card, so that the host is ahead; the median of ``rounds`` rounds
    after two."""
    from nirgan_tpu_torch.ops.int8_trunk import conv_moments_cuda

    times = {name: [] for name in preds}
    for r in range(rounds + 2):
        events = []
        torch.cuda._sleep(2_000_000)
        for name, pred in preds.items():
            x8 = pred()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            conv_moments_cuda(x8, w8)
            b.record()
            events.append((name, a, b))
        torch.cuda.synchronize()
        if r >= 2:
            for name, a, b in events:
                times[name].append(a.elapsed_time(b))
    return {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}


def d_after_e(g: torch.Generator, calls: dict, variants: dict | None = None,
              runner=None) -> dict:
    """``d_after`` for kernel D at (4, 133^2, 256) after itself, after E's
    mode 1 and mode 2 on ``e_calls``' serving inputs (D reading the q that
    E wrote, as in the int8 forward), after mode 1 then a write of 256 MB
    (the L2 flushed), and after that write alone; ``variants`` (name ->
    (a split variant's library, its mode)) adds E's variants through
    ``runner``."""
    from nirgan_tpu_torch.ops.int8_trunk import conv_moments_cuda, norm_quant_cuda

    serving = [args for tag, (args, _) in calls.items() if "count" not in tag]
    by_mode = {args[0]: args for args in serving}
    q1 = norm_quant_cuda(*by_mode[1])
    w8 = torch.randint(-127, 128, (256, 256, 3, 3), device="cuda", generator=g,
                       dtype=torch.int8)
    flush = torch.empty(256 << 20, device="cuda", dtype=torch.uint8)

    def q_of(got):
        return got[1] if isinstance(got, tuple) else got

    def flushed(fn):
        def run():
            x8 = fn()
            flush.zero_()
            return x8
        return run

    preds = {"D": lambda: (conv_moments_cuda(q1, w8), q1)[1],
             "E mode 1": lambda: norm_quant_cuda(*by_mode[1]),
             "E mode 2": lambda: q_of(norm_quant_cuda(*by_mode[2])),
             "E mode 1, then an L2 flush": flushed(lambda: norm_quant_cuda(*by_mode[1])),
             "an L2 flush": flushed(lambda: q1)}
    for name, (lib, mode) in (variants or {}).items():
        preds[name] = (lambda fn: lambda: q_of(fn()))(runner(lib, by_mode[mode]))
    out = d_after(preds, w8)
    del flush
    return out


def phase_split(which: list) -> dict:
    """``--split ROOT [D] [E]`` (the package at ROOT imported, as
    ``--times`` does): kernel D's (``split_d``) and kernel E's
    (``split_e``) variants, both by default."""
    return {k: {"D": split_d, "E": split_e}[k]() for k in which}


# ------------------------------------------------------------- native reader
# the device of phase_native and phase_ddp ("cpu" only to rehearse them at
# a small size on a machine without a card)
DEVICE = "cuda"
NATIVE_SIDE = 256
# the folder of phase_native: 256 tiles of 4 x 256^2 (the Python LZW
# encoder takes about 0.6 s a tile, so few of those)
NATIVE_KINDS = (("npy", 188), ("deflate", 32), ("zstd", 32), ("lzw", 4))
NATIVE_TRAIN = 160  # the .npy tiles the timed steps read: 10 batches of 16
NATIVE_WARM, NATIVE_TIMED = 2, 8


class FolderTiles:
    """The tiles of a folder by the native reader's path index, through the
    port's Python readers (``NpzFolderDataset`` for ``.npy``,
    ``GeoTiffFolderDataset`` for GeoTIFFs): {"index", "tile" (4, s, s)}."""

    def __init__(self, root: str, size: int):
        from nirgan_tpu_torch.data.datasets import GeoTiffFolderDataset, NpzFolderDataset
        from nirgan_tpu_torch.data.native_loader import native_paths

        self.paths = native_paths(root)
        self.where = {}
        for ds in (NpzFolderDataset(root, size), GeoTiffFolderDataset(root, size)):
            self.where.update({p: (ds, j) for j, p in enumerate(ds.files)})

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        ds, j = self.where[self.paths[i]]
        item = ds[j]
        return {"index": np.int64(i), "tile": np.concatenate([item["rgb"], item["nir"]])}


def write_native_folder(root: str, codecs: dict) -> dict:
    """The seeded tiles of ``NATIVE_KINDS`` under ``root/mixed`` (uint16 DN,
    the GeoTIFFs through the port's writer, with the predictor on every
    other one), the first ``NATIVE_TRAIN`` ``.npy`` tiles linked under
    ``root/train``; the tiles of a codec the reader was built without are
    written as ``.npy`` instead, and one of them, alone, under
    ``root/left_out_<codec>``.  Returns the tiles written by kind."""
    from nirgan_tpu_torch.data.geotiff import write_geotiff

    need = {"deflate": "zlib", "zstd": "zstd", "lzw": None, "npy": None}
    mixed, train = os.path.join(root, "mixed"), os.path.join(root, "train")
    os.makedirs(mixed)
    os.makedirs(train)
    rng = np.random.default_rng(SEED)
    written, i = {}, 0
    for kind, n in NATIVE_KINDS:
        if need[kind] is not None and not codecs[need[kind]]:
            lone = os.path.join(root, f"left_out_{kind}")
            os.makedirs(lone)
            write_geotiff(os.path.join(lone, f"t_{kind}.tif"),
                          rng.integers(0, 10000, (4, NATIVE_SIDE, NATIVE_SIDE),
                                       dtype=np.uint16), compression=kind, **SCENE_GRID)
            kind = "npy"
        written[kind] = written.get(kind, 0) + n
        for k in range(n):
            img = rng.integers(0, 10000, (4, NATIVE_SIDE, NATIVE_SIDE), dtype=np.uint16)
            if kind == "npy":
                path = os.path.join(mixed, f"t{i:03d}.npy")
                np.save(path, img)
                if k < NATIVE_TRAIN:
                    os.link(path, os.path.join(train, f"t{i:03d}.npy"))
            else:
                write_geotiff(os.path.join(mixed, f"t{i:03d}_{kind}.tif"), img,
                              compression=kind, predictor=k % 2 == 1, **SCENE_GRID)
            i += 1
    return written


def native_config(train_dir: str, native: bool):
    """``config_px2px.yaml`` training from a folder (``S2_rand``), on the
    native reader or the Python loader."""
    from nirgan_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.Data.dataset_type = "S2_rand"
    cfg.Data.S2_rand_settings = {"base_path": train_dir, "image_size": NATIVE_SIDE}
    cfg.Data.native_loader = native
    return cfg


def phase_native() -> dict:
    """The native tile reader (``data/native_loader.py`` over
    ``csrc/tileio.cc``): its build with ``g++`` and the codecs whose headers
    the compiler found; a seeded folder of 256 tiles of 4 x 256^2 (uint16
    ``.npy`` and GeoTIFFs in deflate, zstd and lzw) read through
    ``NativeNpyDataset`` and through the port's Python ``Loader``, every
    tile keyed by its index (within one f32 step: the reader multiplies by
    1 / 10000 where the Python readers divide); then ``config_px2px.yaml``
    at batch 16 fed from 160 of the ``.npy`` tiles through
    ``dataset_selector`` with ``Data.native_loader`` on and off, in turns
    (native, Python, Python, native): 2 steps, then 8 timed by the host's
    clock to a synchronise, images/s.  A codec whose header the card's
    machine lacks is left out of the reader: its tiles are written as
    ``.npy``, and one tile in it must raise an error that names it.  The
    folder stays until ``phase_native_profile`` has read the card's idle
    share from the same fed steps."""
    from nirgan_tpu_torch.data import dataset_selector
    from nirgan_tpu_torch.data import native_loader as nl
    from nirgan_tpu_torch.data.pipeline import DeviceFeed, Loader
    from nirgan_tpu_torch.tasks import Px2PxTask

    t0 = time.perf_counter()
    path = nl.build()
    build_s = time.perf_counter() - t0
    headers = {name: os.path.exists(os.path.join("/usr/include", hdr))
               for name, (_, _, hdr) in nl.CODECS.items()}
    codecs = nl.codecs()
    log("native", f"tileio ({path.name}) built with g++ in {build_s:.1f} s; the "
        f"preprocessor finds the codecs' headers {nl.codecs_in_source()} (under "
        f"/usr/include: {headers}); codecs in the library: {codecs}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    NATIVE_PROFILE["tmp"] = tmp
    t0 = time.perf_counter()
    written = write_native_folder(tmp, codecs)
    mixed, train = os.path.join(tmp, "mixed"), os.path.join(tmp, "train")
    log("native", f"wrote {written} tiles of 4 x {NATIVE_SIDE}^2 uint16 in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(os.listdir(tmp)):
        if name.startswith("left_out_"):
            reader = nl.NativeTileReader(nl.native_paths(os.path.join(tmp, name)),
                                         crop=NATIVE_SIDE)
            try:
                list(reader)
                raised = "nothing"
            except RuntimeError as e:
                raised = str(e)
            reader.close()
            kind = name[len("left_out_"):]
            log("native", f"a {kind} tile, whose codec the reader was built without: "
                f"{raised}")
            if kind.upper() not in raised:
                raise AssertionError(f"a {kind} tile did not raise naming its codec")

    # every tile by its index, the native reader against the Python loader
    ds = nl.NativeNpyDataset(mixed, image_size=NATIVE_SIDE, batch_size=TRAIN_BATCH,
                             seed=SEED)
    t0 = time.perf_counter()
    native = dict(ds.tiles())
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = {}
    for batch in Loader(FolderTiles(mixed, NATIVE_SIDE), TRAIN_BATCH, num_workers=8,
                        drop_last=False):
        python.update(zip(batch["index"].tolist(), batch["tile"]))
    python_s = time.perf_counter() - t0
    worst, n_diff = 0, 0
    for i, tile in native.items():
        ulps = np.abs(tile.view(np.int32).astype(np.int64)
                      - python[i].view(np.int32).astype(np.int64))
        worst, n_diff = max(worst, int(ulps.max())), n_diff + int((ulps > 0).sum())
    n = sum(written.values())
    log("native", f"{len(native)} tiles by the native reader ({ds.skipped} skipped) in "
        f"{native_s:.2f} s, {len(python)} by the Python loader (8 threads) in "
        f"{python_s:.2f} s; keyed by index, the largest distance {worst} f32 steps "
        f"(bound 1), {n_diff} of {n * 4 * NATIVE_SIDE ** 2} values apart")
    if not (len(native) == len(python) == n and ds.skipped == 0 and worst <= 1):
        raise AssertionError(f"native reader: {len(native)}, {len(python)}, {n}, "
                             f"{ds.skipped}, {worst}")

    # training fed from the folder on both routes, in turns
    task = Px2PxTask(native_config(train, True), device=DEVICE, seed=SEED)
    state = task.init_state()
    depth = int(task.config.tpu.get("prefetch_depth", 0))

    def feed(native: bool):
        dm = dataset_selector(native_config(train, native), seed=SEED)
        if (dm.native_train_iter is not None) != native:
            raise AssertionError(f"Data.native_loader: {native} routed otherwise")
        while True:
            yield from DeviceFeed(dm.train_dataloader(task.embed_coords),
                                  task.extract_batch, depth=depth)

    def images_per_s(native: bool) -> float:
        it = feed(native)
        for _ in range(NATIVE_WARM):
            task.train_step(state, next(it))
        sync()
        t0 = time.perf_counter()
        for _ in range(NATIVE_TIMED):
            task.train_step(state, next(it))
        sync()
        it.close()
        return NATIVE_TIMED * TRAIN_BATCH / (time.perf_counter() - t0)

    reset_counts()
    rates = {True: [], False: []}
    for native in (True, False, False, True):
        rates[native].append(images_per_s(native))
    launched = counts()
    no_library("native")
    out = {"native_img_s": rates[True], "python_img_s": rates[False],
           "build_s": build_s, "codecs": codecs, "max_f32_steps": worst}
    log("native", f"config_px2px.yaml, batch {TRAIN_BATCH}, {NATIVE_WARM} + "
        f"{NATIVE_TIMED} fed steps a run (host clock), in turns: native reader "
        f"{[round(r, 2) for r in rates[True]]} images/s, Python loader "
        f"{[round(r, 2) for r in rates[False]]} images/s; the kernels' launches "
        f"{launched}")
    if min(launched.values()) == 0:
        raise AssertionError(f"a kernel of the step was not launched: {launched}")
    NATIVE_PROFILE.update(task=task, state=state, feed=feed,
                          ms={k: 1e3 * TRAIN_BATCH / np.mean(v) for k, v in rates.items()})
    return out


NATIVE_PROFILE: dict = {}  # what phase_native_profile needs from phase_native


def phase_native_profile() -> dict:
    """The card's idle share in phase_native's fed steps: the device's busy
    time a step under ``torch.profiler`` against the step's time by the
    host's clock read before any profiler attached, on each route.  Run
    after the other phases (an attached profiler slows later launches)."""
    p = NATIVE_PROFILE
    out = {}
    for native in (True, False):
        it = p["feed"](native)
        busy = profile_window(f"a fed step, {'native reader' if native else 'Python loader'}",
                              lambda: p["task"].train_step(p["state"], next(it)),
                              NATIVE_TIMED)
        it.close()
        ms = p["ms"][native]
        out["native" if native else "python"] = {"busy_ms": busy, "step_ms": ms,
                                                 "idle": max(0.0, 1 - busy / ms)}
        log("native", f"{'native reader' if native else 'Python loader'}: device busy "
            f"{busy:.3f} ms a step under the profiler against {ms:.3f} ms a step by the "
            f"host's clock: idle share {max(0.0, 1 - busy / ms):.1%}")
        if not busy > 0:
            raise AssertionError("native profile: the profiler recorded no kernel")
    shutil.rmtree(p.pop("tmp"))
    return out


# ---------------------------------------------------- data parallelism
DDP_WORLD, DDP_STEPS, DDP_TILES = 2, 3, 16
DDP_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.ddp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def sync() -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def ddp_batches(cfg) -> list:
    """``DDP_STEPS`` global batches of the config's train data (NCHW)."""
    from nirgan_tpu_torch.data import dataset_selector

    ds = dataset_selector(cfg).train_ds
    n = int(cfg.Data.train_batch_size)
    out = []
    for s in range(DDP_STEPS):
        items = [ds[i] for i in range(s * n, (s + 1) * n)]
        out.append({k: np.stack([it[k] for it in items]) for k in ("rgb", "nir")})
    return out


def ddp_small_config():
    """phase_train's f32 check config (``resnet_6blocks``, 64^2) at a
    global batch of 4."""
    from nirgan_tpu_torch.config import load_config

    small = load_config(CONFIG)
    small.tpu.compute_dtype = "float32"
    small.base_configs.netG = "resnet_6blocks"
    small.Data.train_batch_size = 4
    small.Data.fake_settings.image_size = 64
    return small


def ddp_rows(batch: dict, rank: int) -> dict:
    n = next(iter(batch.values())).shape[0] // DDP_WORLD
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def serving_argv(folder: str, out: str) -> list:
    return ["--config", CONFIG, "--data", os.path.join(folder, "data"), "--out",
            os.path.join(folder, out), "--ckpt", os.path.join(folder, "no.ckpt"),
            "--device", DEVICE, "--batch-size", str(BATCH)]


def scene_argv(folder: str, out: str) -> list:
    return [os.path.join(folder, "scene.tif"), os.path.join(folder, out), "--config",
            CONFIG, "--tile", str(SCENE_TILE), "--overlap", str(SCENE_OVERLAP),
            "--batch-size", str(SCENE_BATCH), "--compression", "none", "--device", DEVICE]


def ddp_rank(rank: int, init_file: str, folder: str) -> None:
    """One of two processes on the one card over gloo (``phase_ddp``): the
    bf16 steps of ``config_px2px.yaml`` on its half of each global batch,
    the f32 runs of the C9 rule on its half of the small config's, the
    serving CLI with ``--mesh`` (its strided slice of the tiles) and the
    scene CLI under ``NIRGAN_MULTIHOST`` (its row band; rank 0 writes).
    Its results go to ``rank{rank}.pt`` in ``folder``."""
    from nirgan_tpu_torch import create_synthetic_dataset, synthesize_scene
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.parallel import create_mesh, initialize_multihost
    from nirgan_tpu_torch.tasks import Px2PxTask

    os.chdir(ROOT)
    # both processes on the one card (or the CPU), over gloo
    one = DEVICE if DEVICE == "cpu" else f"{DEVICE}:0"
    initialize_multihost(init_method=f"file://{init_file}", world_size=DDP_WORLD,
                         rank=rank, device=one, backend="gloo", timeout_s=600)
    mesh = create_mesh(one)
    out = {}
    cfg = load_config(CONFIG)
    task = Px2PxTask(cfg, device=DEVICE, seed=SEED).use_mesh(mesh)
    state = task.init_state()
    terms, ms = [], []
    reset_counts()
    for batch in ddp_batches(cfg):
        ex = task.extract_batch(ddp_rows(batch, rank))
        sync()
        t0 = time.perf_counter()
        terms.append(loss_terms(task.train_step(state, ex)))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["bf16"] = {"terms": terms, "ms": ms, "launches": counts(),
                   "G": {k: v.cpu() for k, v in task.netG.state_dict().items()}}
    del task, state

    small = ddp_small_config()
    batch = ddp_rows(ddp_batches(small)[0], rank)
    want = torch.load(os.path.join(folder, "f32_want.pt"))
    lr = float(small.base_configs.lr)
    with cudnn_tf32(False):
        task, got = seeded_step(small, batch, DEVICE, mesh=mesh)
        swapped = []
        mixed = seeded_step(small, batch, DEVICE, after_d=set_where_flipped(want, lr, swapped),
                            mesh=mesh)[1]
        got0 = seeded_step(small, batch, DEVICE, lr=0.0, mesh=mesh)[1]
    out["f32"] = {"terms": got, "terms0": got0, "mixed": mixed, "swapped": sum(swapped),
                  "grads": {k: p.grad.detach().cpu() for k, p in task.netD.named_parameters()},
                  "params": {k: p.detach().cpu() for k, p in task.netD.named_parameters()}}
    del task
    reset_counts()
    create_synthetic_dataset.main(serving_argv(folder, "two") + ["--mesh"])
    os.environ["NIRGAN_MULTIHOST"] = "1"
    t0 = time.perf_counter()
    synthesize_scene.main(scene_argv(folder, "scene_two.tif"))
    out["scene_s"] = time.perf_counter() - t0
    out["serving_launches"] = counts()
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))


def run_processes(argvs: list, timeout: int, what: str) -> list:
    """Run the commands together (``ROOT`` on their PYTHONPATH); their
    output, or an error with it if one fails."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("NIRGAN_MULTIHOST", None)
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, cwd=ROOT) for argv in argvs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0].decode(errors="replace"))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{what} failed:\n" + "\n---\n".join(o[-4000:] for o in outs))
    return outs


def same_tree(a, b) -> bool:
    """Two nested checkpoints equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def phase_ddp(tmp: str) -> dict:
    """Data parallelism over ``torch.distributed`` on the one card:

    (a) two processes on the card over gloo, each at batch 8, against one
        process at batch 16 on the concatenated global batch: three bf16
        fused steps of ``config_px2px.yaml`` (the eight terms within 2% +
        1e-3, the port's bf16 bound; equal on both ranks, and G's weights
        after the steps too; the kernels launched in the ranks), and one
        f32 step of phase_train's small config at a global batch of 4
        held by ``check_f32_step``'s rule (C9), TF32 off;
    (b) ``python -m nirgan_tpu_torch.train`` under torchrun on one process
        over NCCL (world size 1), 3 steps, against the same CLI without a
        process group (run beside (a)): the checkpoints and the logged
        terms bit for bit;
    (c) the 3000 x 4000 scene through the scene CLI in two row bands
        (``NIRGAN_MULTIHOST``; rank 0 gathers and writes) against the CLI
        in one process: bit for bit (each band runs the one-process run's
        window batches that touch it, whole);
    (d) ``create_synthetic_dataset --mesh`` on the two ranks (a strided
        slice of 16 tiles each) against one process: the same ``.npz``
        files bit for bit.

    The step times are printed as a baseline only: two processes sharing
    one card over gloo (whose all-reduce goes through the host) are not a
    measurement of data parallelism across cards."""
    from nirgan_tpu_torch import create_synthetic_dataset, synthesize_scene
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.data.geotiff import read_geotiff, write_geotiff
    from nirgan_tpu_torch.tasks import Px2PxTask

    folder = os.path.join(tmp, "ddp")
    os.makedirs(folder)
    write_tiles(os.path.join(folder, "data"), DDP_TILES)
    write_geotiff(os.path.join(folder, "scene.tif"), seeded_scene(SCENE_H, SCENE_W),
                  compression="none", **SCENE_GRID)

    # one process on the global batches: the references
    cfg = load_config(CONFIG)
    task = Px2PxTask(cfg, device=DEVICE, seed=SEED)
    state = task.init_state()
    ref_terms, ref_ms = [], []
    for batch in ddp_batches(cfg):
        ex = task.extract_batch(batch)
        sync()
        t0 = time.perf_counter()
        ref_terms.append(loss_terms(task.train_step(state, ex)))
        sync()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    del task, state
    small = ddp_small_config()
    lr = float(small.base_configs.lr)
    with cudnn_tf32(False):
        one, ref = seeded_step(small, ddp_batches(small)[0], DEVICE)
        ref0 = seeded_step(small, ddp_batches(small)[0], DEVICE, lr=0.0)[1]
    f32_ref = {"terms": ref, "terms0": ref0,
               "grads": {k: p.grad.detach().cpu() for k, p in one.netD.named_parameters()},
               "params": {k: p.detach().cpu() for k, p in one.netD.named_parameters()}}
    torch.save(f32_ref["params"], os.path.join(folder, "f32_want.pt"))
    del one

    # (a), (c), (d): two processes on the card over gloo; beside them the
    # train CLI without a process group, (b)'s reference (its time is not
    # read)
    def train_cli(tag: str, launcher: list) -> list:
        return launcher + ["-m", "nirgan_tpu_torch.train", "--config", CONFIG,
                           "--max-steps", "3", "--log-every", "1", "--device", DEVICE,
                           "--logdir", os.path.join(folder, f"run_{tag}")]

    t0 = time.perf_counter()
    outs = run_processes([[sys.executable, "-c", DDP_RANK, ROOT, str(rank),
                           os.path.join(folder, "rendezvous"), folder]
                          for rank in range(DDP_WORLD)]
                         + [train_cli("none", [sys.executable])], 900,
                         "the two ranks and the train CLI")
    ranks_s = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(folder, f"rank{r}.pt")) for r in range(DDP_WORLD))
    same_ranks = (r0["bf16"]["terms"] == r1["bf16"]["terms"]
                  and same_tree(r0["bf16"]["G"], r1["bf16"]["G"]))
    for s, (got, want) in enumerate(zip(r0["bf16"]["terms"], ref_terms)):
        check_terms(f"two ranks of batch 8 over gloo vs one process of 16, bf16 step "
                    f"{s + 1}", got, want, 2e-2, 1e-3)
    launched = r0["bf16"]["launches"]
    log("ddp", f"the ranks in {ranks_s:.1f} s; terms and G's weights equal on both ranks: "
        f"{same_ranks}; launches a rank over {DDP_STEPS} steps {launched}; step ms "
        f"(host clock to a synchronise): rank 0 {np.round(r0['bf16']['ms'], 3).tolist()}, "
        f"rank 1 {np.round(r1['bf16']['ms'], 3).tolist()}, one process at batch "
        f"{TRAIN_BATCH} {np.round(ref_ms, 3).tolist()}")
    if not same_ranks or min(launched.values()) == 0:
        raise AssertionError(f"two ranks: {same_ranks}, {launched}")
    hold_f32_step("two ranks of batch 2 over gloo vs one process of 4, f32 step 1", lr,
                  f32_ref, r0["f32"])
    if not (r0["f32"]["terms"] == r1["f32"]["terms"]
            and same_tree(r0["f32"]["params"], r1["f32"]["params"])):
        raise AssertionError("the f32 step differs between the ranks")

    # (d) the serving CLI in one process against the two ranks' tiles
    reset_counts()
    create_synthetic_dataset.main(serving_argv(folder, "one"))
    names = sorted(os.listdir(os.path.join(folder, "one")))
    two = sorted(os.listdir(os.path.join(folder, "two")))
    differ = [n for n in names if not np.array_equal(
        np.load(os.path.join(folder, "one", n))["nir"],
        np.load(os.path.join(folder, "two", n))["nir"])]
    log("ddp", f"create_synthetic_dataset --mesh on two ranks: {len(two)} tiles, one "
        f"process {len(names)}; tiles that differ: {len(differ)} (must be 0); "
        f"launches a rank {r0['serving_launches']}")
    if two != names or len(names) != DDP_TILES or differ:
        raise AssertionError(f"bulk serving over two ranks: {two}, {names}, {differ}")

    # (c) the scene CLI in one process against the two bands
    t0 = time.perf_counter()
    synthesize_scene.main(scene_argv(folder, "scene_one.tif"))
    one_s = time.perf_counter() - t0
    a, meta_a = read_geotiff(os.path.join(folder, "scene_one.tif"))
    b, meta_b = read_geotiff(os.path.join(folder, "scene_two.tif"))
    same = a.shape == b.shape == (1, SCENE_H, SCENE_W) and np.array_equal(a, b)
    log("ddp", f"the {SCENE_H} x {SCENE_W} scene CLI in two row bands (rank 0 writes): "
        f"bit for bit with one process: {same}, max |diff| "
        f"{float(np.abs(a - b).max()) if a.shape == b.shape else 'shape'}; wall "
        f"{r0['scene_s']:.2f} s on the ranks, {one_s:.2f} s in one process (host clock)")
    if not (same and meta_a["epsg"] == meta_b["epsg"]):
        raise AssertionError("the banded scene differs from one process")

    # (b) the train CLI under torchrun, one process over NCCL, against none
    t0 = time.perf_counter()
    nccl_out = run_processes([train_cli("nccl", [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "1"])], 600, "the train CLI under torchrun")[0]
    nccl_s = time.perf_counter() - t0
    runs = {}
    for tag, out in (("nccl", nccl_out), ("none", outs[DDP_WORLD])):
        logdir = os.path.join(folder, f"run_{tag}")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        runs[tag] = {"rows": rows, "out": out,
                     "ckpt": torch.load(os.path.join(logdir, "last.pt"))}
    strip = lambda rows: [{k: v for k, v in r.items()
                           if k != "time" and not k.startswith("perf/")} for r in rows]
    same_ckpt = same_tree(runs["nccl"]["ckpt"], runs["none"]["ckpt"])
    same_rows = strip(runs["nccl"]["rows"]) == strip(runs["none"]["rows"])
    step_ms = {tag: [r["perf/step_ms"] for r in run["rows"] if "perf/step_ms" in r]
               for tag, run in runs.items()}
    log("ddp", f"train CLI, 3 steps: under torchrun over NCCL (world size 1) vs no process "
        f"group (run beside the two ranks): last.pt bit for bit {same_ckpt}, logged "
        f"terms and metrics equal {same_rows}; perf/step_ms under torchrun "
        f"{np.round(step_ms['nccl'], 3).tolist()} (the one process's step alone "
        f"{np.round(ref_ms, 3).tolist()}); wall {nccl_s:.1f} s")
    backend = "over nccl" if DEVICE == "cuda" else "over gloo"
    if backend not in runs["nccl"]["out"] or "processes" in runs["none"]["out"]:
        raise AssertionError(f"the train CLI under torchrun did not train {backend}:\n"
                             + runs["nccl"]["out"][-2000:])
    if not (same_ckpt and same_rows):
        raise AssertionError(f"train CLI over NCCL: {same_ckpt}, {same_rows}")
    return {"two_rank_ms": [r0["bf16"]["ms"], r1["bf16"]["ms"]], "one_ms": ref_ms,
            "nccl_step_ms": step_ms["nccl"], "scene_s": {"two": r0["scene_s"], "one": one_s}}


# ----------------------------------------------------- spatial sharding
SPATIAL_SIDE = 2048  # (a) and (b): one seeded tile at the config's pad 10
SPATIAL_F32_SIDE = 512  # (c)
SPATIAL_GRID, SPATIAL_GRID_BATCH = (2, 2), 2  # (d): batch 2 of 512^2 in bf16
SPATIAL_TRUNKS = ("reflect", "replicate", "zero")
# wrapper calls a rank makes in one sharded forward of the 9-block
# generator: A in VALID mode on the trunk's slabs, B's split forward for
# every norm, C once
SPATIAL_FORWARD = {"trunk_conv_pad0": 18, "trunk_conv_pad1": 0, "instance_norm": 0,
                   "instance_norm_sums": 23, "instance_norm_apply": 23, "head_conv": 1}
# wrapper calls a rank makes in one sharded unet_256 forward (13 instance
# norms): sharded down to level 8 (2048^2 over two ranks, 512^2 in a grid
# row of two, one process), every norm B's split forward; to level 7 (512^2
# over four ranks), the innermost block's norm B's one call on the gathered
# map; the batch-norm U-Net none of B's
UNET_SPATIAL_NORMS = ("instance_norm", "instance_norm_sums", "instance_norm_apply")
UNET_SPATIAL_LEVEL8 = {"instance_norm": 0, "instance_norm_sums": 13, "instance_norm_apply": 13}
UNET_SPATIAL_LEVEL7 = {"instance_norm": 1, "instance_norm_sums": 12, "instance_norm_apply": 12}
UNET_SPATIAL_BATCH = {"instance_norm": 0, "instance_norm_sums": 0, "instance_norm_apply": 0}
SPATIAL_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.spatial_rank(*sys.argv[2:])
"""


def spatial_task(dtype: str = "bfloat16", trunk: str = "reflect"):
    """``config_px2px.yaml``'s task (resnet_9blocks, ngf 64, pad 10) in
    ``dtype`` with the trunk's ``padding_type`` set to ``trunk``, seeded."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = load_config(CONFIG)
    cfg.tpu.compute_dtype = dtype
    task = Px2PxTask(cfg, device=DEVICE, seed=SEED)
    task.netG.padding_type = trunk
    for i in range(task.netG.n_blocks):
        getattr(task.netG, f"r{i}").padding_type = trunk
    return task


def spatial_unet_task(dtype: str = "bfloat16", norm: str = "instance"):
    """``unet_config``'s task (unet_256, ngf 64, unpadded) with ``norm`` in
    ``dtype``, seeded (a batch norm serves in eval mode)."""
    from nirgan_tpu_torch.tasks import Px2PxTask

    cfg = unet_config(norm=norm)
    cfg.tpu.compute_dtype = dtype
    return Px2PxTask(cfg, device=DEVICE, seed=SEED)


def spatial_tile(side: int, batch: int = 1, seed: int = SEED) -> np.ndarray:
    """A seeded (batch, 3, side, side) reflectance tile."""
    return np.random.default_rng(seed).random((batch, 3, side, side), dtype=np.float32) * 0.3


def spatial_counts() -> dict:
    """The wrapper calls of the sharded forward's kernels since the last
    reset: A by pad mode, B (one call and split), C, D by gather, E by mode,
    and the library routes."""
    a = kernels()["trunk_conv"]
    out = {"trunk_conv_pad0": a.by_pad.get(0, 0), "trunk_conv_pad1": a.by_pad.get(1, 0),
           "instance_norm": kernels()["instance_norm"].launches,
           **{k: fn.launches for k, fn in split_norm_kernels().items()},
           "head_conv": kernels()["head_conv"].launches}
    out.update(int8_by_route())
    out["library"] = sum(library_counts().values())
    return out


def sharded_counts(fn) -> tuple:
    """``fn()`` and the wrapper calls it made."""
    reset_counts()
    out = fn()
    sync()
    return out, spatial_counts()


def timed_sharded_forward(task, rgb: np.ndarray, mesh) -> dict:
    """``predict_large_tile`` of the (1, 3, S, S) tile over ``mesh``: the
    prediction, this rank's wrapper calls and peak device memory, its rows
    and its forward's ms (CUDA events, this rank's rows in, its rows out)."""
    from nirgan_tpu_torch.parallel.spatial import (
        predict_large_tile,
        shard_ranges,
        spatial_predict_fn,
    )

    torch.cuda.reset_peak_memory_stats()
    pred, launches = sharded_counts(lambda: predict_large_tile(task, rgb, mesh))
    peak = torch.cuda.max_memory_allocated()
    fn = spatial_predict_fn(task, mesh)
    side = rgb.shape[2]
    p = task.pad_amount
    x = torch.from_numpy(np.pad(rgb.transpose(0, 2, 3, 1), ((0, 0), (p, p), (p, p), (0, 0)),
                                mode="reflect"))
    lo, hi = shard_ranges(task, x.shape[1], mesh.world_size)[mesh.rank]
    rows = x[:, lo:hi].to(mesh.device)
    ms = time_ms(lambda: fn(rows, side), iters=3, warmup=1)
    return {"pred": pred, "launches": launches, "peak": peak, "ms": ms, "rows": (lo, hi)}


def spatial_rank(folder: str, init_file: str, rank: str, world: str, part: str) -> None:
    """One process of ``phase_spatial`` on the one card: ``part`` "two"
    runs (e) (also layer by layer and in f32), (g) and (a)-(c) as one of
    two ranks over gloo, and on rank 0 ``layers_alone`` last, "grid" (d),
    (h) and (f) as one of four, "nccl" (c) and (f) alone under torchrun over
    NCCL.  Its results go to ``{part}{rank}.pt`` in ``folder``."""
    from nirgan_tpu_torch.parallel import create_mesh, initialize_multihost
    from nirgan_tpu_torch.parallel.spatial import (
        create_grid,
        predict_large_tile,
        predict_tiles_2d,
    )

    os.chdir(ROOT)
    rank, world = int(rank), int(world)
    if part == "nccl":
        initialize_multihost(device=DEVICE)
    else:
        initialize_multihost(init_method=f"file://{init_file}", world_size=world, rank=rank,
                             device=f"{DEVICE}:0", backend="gloo", timeout_s=600)
    mesh = create_mesh(f"{DEVICE}:0")
    out = {"backend": mesh.backend, "world": mesh.world_size}
    rgb32 = spatial_tile(SPATIAL_F32_SIDE, 1, SEED + 1)
    if part == "grid":
        grid = create_grid(mesh, *SPATIAL_GRID)
        batch = spatial_tile(SPATIAL_F32_SIDE, SPATIAL_GRID_BATCH, SEED + 2)
        out["grid"], out["launches"] = sharded_counts(
            lambda: predict_tiles_2d(spatial_task(), batch, grid))
        pred, launches = sharded_counts(
            lambda: predict_tiles_2d(spatial_unet_task(), batch, grid))
        out["h"] = {"pred": pred, "launches": launches}
    if part in ("grid", "nccl"):
        with cudnn_tf32(False):
            pred, launches = sharded_counts(
                lambda: predict_large_tile(spatial_unet_task("float32"), rgb32, mesh))
        out["f"] = {"pred": pred, "launches": launches}
    if part == "two":
        rgb = spatial_tile(SPATIAL_SIDE)
        # the U-Nets first, so that only their weights and tile are on the
        # card when the peak is read
        for key, norm in (("e", "instance"), ("g", "batch")):
            out[key] = timed_sharded_forward(spatial_unet_task(norm=norm), rgb, mesh)
            torch.cuda.empty_cache()
        # (e) layer by layer against the whole tile's forward in this
        # process, then in f32
        out["e"]["layers"] = layer_parts(spatial_unet_task(), rgb, mesh)
        with cudnn_tf32(False):
            out["e32"] = predict_large_tile(spatial_unet_task("float32"), rgb, mesh)
        torch.cuda.empty_cache()
        task = spatial_task()
        out["a"] = timed_sharded_forward(task, rgb, mesh)
        for name in ("int8", "stage2"):
            pack = torch.load(os.path.join(folder, f"{name}.pt"), map_location=DEVICE)
            reset_counts()
            out[name] = {"pred": predict_large_tile(task, rgb, mesh, trunk_q=pack),
                         "launches": spatial_counts()}
            sync()
    if part in ("two", "nccl"):
        with cudnn_tf32(False):
            out["f32"] = {trunk: predict_large_tile(spatial_task("float32", trunk), rgb32, mesh)
                          for trunk in SPATIAL_TRUNKS}
    if part == "two" and rank == 0:
        # each layer of (e) and of (h)'s first sample alone, after every
        # collective: it attaches the profiler, which this process then
        # keeps
        task = spatial_unet_task()
        first = spatial_tile(SPATIAL_F32_SIDE, SPATIAL_GRID_BATCH, SEED + 2)[:1]
        out["alone"] = {side: layers_alone(task, torch.from_numpy(np.ascontiguousarray(
            t.transpose(0, 2, 3, 1))).to(DEVICE)) for side, t in
            ((SPATIAL_SIDE, rgb), (SPATIAL_F32_SIDE, first))}
    torch.save(out, os.path.join(folder, f"{part}{rank}.pt"))


def check_split_norm(g: torch.Generator, shape: tuple, cuts: list | None = None,
                     relu: bool = True, timed: bool = True) -> dict:
    """B's split forward against its plain version on a map of ``shape``
    (B, H, W, C) cut into the rows ``cuts`` (by default the two shards of
    (a), ``row_ranges``): each shard's sums (the exact pairs added, against
    f32 sums in another order: within 1e-5 of sqrt(n Sigma x^2), as D's
    moments), and each shard's elementwise pass on the gathered sums of
    every shard, with the ReLU and with the skip (``relu`` False: with
    neither, as the U-Net's norms), f32 within 1e-5 and bf16 within
    ``check_norm``'s bound of the plain version on the same sums, and
    against kernel B's one call on the whole map.  With ``timed``, times
    the sums and the pass (ReLU'd where ``relu``) at shard 0's shape beside
    their plain versions, the bound and, for the pass, ``F.batch_norm``;
    else returns the largest errors only."""
    import torch.nn.functional as F

    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_apply_cuda,
        instance_norm_apply_plain,
        instance_norm_cuda,
        instance_norm_plain,
        instance_norm_sums_cuda,
        instance_norm_sums_plain,
    )
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    dev = torch.device("cuda")
    b, h, w, c = shape
    x = torch.randn(shape, device=dev, generator=g) * 2.0 + 0.5
    res = torch.randn(shape, device=dev, generator=g)
    cuts = cuts or row_ranges(h, 2)
    modes = ((True, False), (False, True)) if relu else ((False, False),)
    worst = {"sums": 0.0, "apply": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        xd, rd = x.to(dtype), res.to(dtype)
        pieces = [xd[:, lo:hi].contiguous() for lo, hi in cuts]
        sums = [instance_norm_sums_cuda(p) for p in pieces]
        for p, s in zip(pieces, sums):
            ref = instance_norm_sums_plain(p)
            n = p.shape[1] * p.shape[2]
            scale = (n * ref[:, 1]).sqrt().clamp(min=1e-30)
            e1 = float(((s[:, 0] + s[:, 2] - ref[:, 0]).abs() / scale).max())
            e2 = float(((s[:, 1] + s[:, 3] - ref[:, 1]).abs() / ref[:, 1].abs()).max())
            worst["sums"] = max(worst["sums"], e1, e2)
            if not (e1 <= 1e-5 and e2 <= 1e-5):
                raise AssertionError(f"instance_norm_sums {dtype} {tuple(p.shape)}: {e1}, {e2}")
        parts = torch.stack(sums, 1)
        whole = instance_norm_cuda(xd, relu=relu)
        for i, (lo, hi) in enumerate(cuts):
            for fused, skip in modes:
                r = rd[:, lo:hi].contiguous() if skip else None
                got = instance_norm_apply_cuda(pieces[i], parts, h * w, relu=fused,
                                               residual=r).float()
                ref = instance_norm_apply_plain(pieces[i], parts, h * w, relu=fused,
                                                residual=r).float()
                err = (got - ref).abs()
                if dtype == torch.float32:
                    ok, bound = bool((err <= 1e-5).all()), "abs 1e-5"
                else:
                    y = instance_norm_apply_plain(pieces[i], parts, h * w, relu=fused).float()
                    lim = 2 ** -6 * (y.abs() + 1) + (2 ** -7 * ref.abs() if skip else 0)
                    ok, bound = bool((err <= lim).all()), "2^-6 (|y| + 1)"
                    worst["apply"] = max(worst["apply"], float(err.max()))
                log("spatial", f"instance_norm_apply {dtype} shard {i} of {len(cuts)} "
                    f"{tuple(pieces[i].shape)} relu={fused} skip={skip}: max|err| "
                    f"{float(err.max()):.3e} against the plain version (bound {bound})")
                if not ok:
                    raise AssertionError(f"instance_norm_apply {dtype} shard {i}: "
                                         f"{float(err.max())}")
            # against kernel B's one call on the whole map
            split = instance_norm_apply_cuda(pieces[i], parts, h * w, relu=relu).float()
            one = whole[:, lo:hi].float()
            lim = 2 ** -6 * (one.abs() + 1) if dtype == torch.bfloat16 else 1e-5
            if not bool(((split - one).abs() <= lim).all()):
                raise AssertionError(f"split vs one call {dtype} shard {i}: "
                                     f"{float((split - one).abs().max())}")
    if not timed:
        return worst
    xb = x.bfloat16()[:, cuts[0][0]:cuts[0][1]].contiguous()
    parts = torch.stack([instance_norm_sums_cuda(xb), instance_norm_sums_cuda(xb)], 1)
    sums_ms, sums_plain = compare_ms(lambda: instance_norm_sums_cuda(xb),
                                     lambda: instance_norm_sums_plain(xb), iters=10,
                                     run_ahead=True)
    # the library's stand-in for the apply: F.batch_norm in eval mode on the
    # NCHW view (B = 1: per channel, as the instance norm), given the tile's
    # mean and variance, without the ReLU (as F.instance_norm for kernel B)
    count = 2 * xb.shape[1] * w
    total = parts[:, 0] + parts[:, 1]
    mean = (total[0, 0] + total[0, 2]) / count
    var = (total[0, 1] + total[0, 3]) / count - mean.square()
    lib_y = F.batch_norm(xb.permute(0, 3, 1, 2), mean, var, training=False,
                         eps=1e-5).permute(0, 2, 3, 1).float()
    lib_y = torch.relu(lib_y) if relu else lib_y
    ref_y = instance_norm_apply_plain(xb, parts, count, relu=relu).float()
    lib_err = float((lib_y - ref_y).abs().max())
    if not bool(((lib_y - ref_y).abs() <= 2 ** -6 * (ref_y.abs() + 1)).all()):
        raise AssertionError(f"F.batch_norm as the apply's stand-in: {lib_err}")
    del lib_y, ref_y
    apply_ms, apply_plain, apply_lib = compare_ms(
        lambda: instance_norm_apply_cuda(xb, parts, count, relu=relu),
        lambda: instance_norm_apply_plain(xb, parts, count, relu=relu),
        lambda: F.batch_norm(xb.permute(0, 3, 1, 2), mean, var, training=False, eps=1e-5),
        iters=10, run_ahead=True)
    sums_least = least_time(0, nbytes(xb) + 16 * b * c)
    apply_least = least_time(0, 2 * nbytes(xb) + nbytes(parts))
    log("spatial", f"split norm bf16 at shard 0's {tuple(xb.shape)}: sums {sums_ms:.4f} ms "
        f"({sums_least[0] / sums_ms * 100:.0f}% of the bound {sums_least[0]:.4f} ms), plain "
        f"{sums_plain:.4f} ms; apply (relu={relu}) {apply_ms:.4f} ms ({apply_least[0] / apply_ms * 100:.0f}"
        f"% of the bound {apply_least[0]:.4f} ms), plain {apply_plain:.4f} ms, F.batch_norm "
        f"(eval, no ReLU; max |err| {lib_err:.3e} with relu={relu}) {apply_lib:.4f} ms; max "
        f"errs {worst}")
    note = "no single PyTorch call computes this part of the norm: library_ms null"
    lib_note = ("library_ms: F.batch_norm in eval mode on the NCHW view with the tile's "
                "mean and variance (B = 1), without the ReLU"
                + ("" if relu else "; the apply timed without it too, as the U-Net"))
    return {"instance_norm_sums": (worst["sums"], (tuple(xb.shape), sums_ms, sums_plain, None,
                                                   sums_least, dict(note=note))),
            "instance_norm_apply": (worst["apply"], (tuple(xb.shape), apply_ms, apply_plain,
                                                     apply_lib, apply_least,
                                                     dict(note=lib_note)))}


# kernel D without a border against its plain version: (stride, shape,
# Cout).  wgmma: tiles across two images (N 256 and 128), odd and even
# sides; mma.sync: a Cout that is no multiple of 128, images under a tile
VALID_SHAPES = ((1, (3, 14, 13, 256), 256), (1, (3, 22, 32, 128), 128),
                (1, (2, 11, 13, 32), 40), (2, (3, 29, 27, 128), 256),
                (2, (3, 30, 28, 128), 256), (2, (2, 35, 37, 128), 128),
                (2, (2, 12, 9, 64), 40))


def check_int8_norm_count(g: torch.Generator, hb: torch.Tensor, m: torch.Tensor,
                          count: int) -> tuple[float, tuple]:
    """Kernel E with a pixel count that is not its input's HW (the tile's,
    on a shard) against its plain version given the same count, in modes 1
    to 3 (int8 outputs at most one step apart on at most 1e-4 of them, the
    streams within one step); and different from E without the count, so
    the count reached the kernel; on grids cut short, bit for bit with its
    plan's (``check_norm_plans``).  Returns the largest |kernel - plain| over
    the three modes' outputs (int8 steps and stream values) and the times in
    mode 1."""
    from nirgan_tpu_torch.ops.int8_trunk import norm_quant_cuda, norm_quant_plain

    dev = torch.device("cuda")
    eps, s = e_constants(g, m)
    xs = (torch.randn(tuple(hb.shape), device=dev, generator=g) * 2.0).bfloat16()
    tag = f"int8_norm {tuple(hb.shape)} count {count}"
    q1 = norm_quant_cuda(1, hb, s, m, eps, count=count)
    err = steps_apart(q1, norm_quant_plain(1, hb, s, m, eps, count=count), f"{tag} mode 1")
    o2, q2 = norm_quant_cuda(2, hb, s, m, eps, xs, count=count)
    r2, rq2 = norm_quant_plain(2, hb, s, m, eps, xs, count=count)
    err = max(err, steps_apart(q2, rq2, f"{tag} mode 2"), abs_err(o2, r2))
    within_ulp(o2, r2, f"{tag} mode 2 stream", addend=xs)
    o3, q3 = norm_quant_cuda(3, hb, s, m, eps, dtype=torch.bfloat16, count=count)
    r3, rq3 = norm_quant_plain(3, hb, s, m, eps, dtype=torch.bfloat16, count=count)
    within_ulp(o3, r3, f"{tag} mode 3 stream")
    err = max(err, steps_apart(q3, rq3, f"{tag} mode 3"), abs_err(o3, r3))
    if torch.equal(q1, norm_quant_cuda(1, hb, s, m, eps)):
        raise AssertionError(f"{tag}: the count did not reach the kernel")
    # the grid cut short: the same outputs on fewer blocks than the plan's
    check_norm_plans(tag, ((1, hb, s, m, eps, None, None, count), q1),
                     ((2, hb, s, m, eps, xs, None, count), (o2, q2)),
                     ((3, hb, s, m, eps, None, torch.bfloat16, count), (o3, q3)))
    ms, plain_ms = compare_ms(lambda: norm_quant_cuda(1, hb, s, m, eps, count=count),
                              lambda: norm_quant_plain(1, hb, s, m, eps, count=count),
                              iters=20, run_ahead=True)
    least = least_time(0, nbytes(hb, m) + hb.numel())
    log("spatial", f"{tag} mode 1: kernel {ms:.4f} ms ({least[0] / ms * 100:.0f}% of the "
        f"bound {least[0]:.4f} ms), plain {plain_ms:.4f} ms; max |kernel - plain| {err}")
    return err, (tuple(hb.shape), ms, plain_ms, None, least)


def spatial_kernel_checks(g: torch.Generator) -> None:
    """The kernels' new entry points against their plain versions at the
    shapes of (a)'s shard 0 (2068 padded rows, 1036 of them; 2068 wide):
    B's split forward at the stem's (1036, 2068, 64); D's VALID gathers at
    the trunk's slab (261, 519, 256) -> (259, 517, 256) and stage 2's d1
    slab (519, 1036, 128) -> 256 at stride 2, exact in s32, timed beside
    the bound, and at ``VALID_SHAPES``; E with the tile's count at the
    trunk's shard.  Their entries go to ``RESULTS``."""
    from nirgan_tpu_torch.ops.int8_trunk import conv_moments_cuda, conv_moments_plain

    from nirgan_tpu_torch.parallel.spatial import row_ranges

    side = SPATIAL_SIDE + 2 * PAD
    lo, hi = row_ranges(side, 2)[0]
    split = check_split_norm(g, (1, side, side, 64))
    err = 0.0
    for stride, shape, co in VALID_SHAPES:
        err = max(err, check_int8_conv(g, shape, co, border="valid", stride=stride)[-1])
    trunk_rows, trunk_w = (hi - lo) // 4, side // 4
    timed = {}
    for key, stride, shape, co in (
            ("int8_conv_valid", 1, (1, trunk_rows + 2, trunk_w + 2, 256), 256),
            ("int8_conv_stride2_valid", 2, (1, 2 * trunk_rows + 1, side // 2 + 2, 128), 256)):
        x8, w8, hb, m, e = check_int8_conv(g, shape, co, border="valid", stride=stride)
        err = max(err, e)
        # the plain version convolves in float64: few calls
        ms, plain_ms = compare_ms(lambda: conv_moments_cuda(x8, w8, "valid", stride),
                                  lambda: conv_moments_plain(x8, w8, "valid", stride),
                                  iters=3, run_ahead=True)
        ops = 2 * hb.shape[0] * hb.shape[1] * hb.shape[2] * 9 * shape[3] * co
        least = least_time(ops, nbytes(x8, w8, hb, m), PEAK_INT8_OPS)
        log("spatial", f"{key} {shape}->{co} s{stride}: kernel {ms:.4f} ms "
            f"({least[0] / ms * 100:.0f}% of the bound {least[0]:.4f} ms, {least[1]}), "
            f"plain {plain_ms:.4f} ms")
        timed[key] = (shape, ms, plain_ms, None, least, dict(
            note="no PyTorch call convolves int8 on a card: library_ms null"))
        if key == "int8_conv_valid":
            # the trunk's shard: its moments count the tile's trunk pixels
            e_err, e_times = check_int8_norm_count(g, hb, m, (side // 4) * trunk_w)
    src = {"instance_norm_sums": ("instance_norm.cu", "nirgan_tpu/ops/pallas_kernels.py:130"),
           "instance_norm_apply": ("instance_norm.cu", "nirgan_tpu/ops/pallas_kernels.py:130"),
           "int8_conv_valid": ("int8_conv.cu", "nirgan_tpu/ops/int8_trunk.py:103"),
           "int8_conv_stride2_valid": ("int8_conv.cu", "nirgan_tpu/ops/int8_trunk.py:130"),
           "int8_norm_count": ("int8_norm.cu", "nirgan_tpu/ops/int8_trunk.py:94")}
    for name, (e, t) in split.items():
        RESULTS[name] = entry(name, src[name][0], src[name][1], e, t)
    check_split_norm_unet(g)
    for name, t in timed.items():
        RESULTS[name] = entry(name, src[name][0], src[name][1], err, t)
    RESULTS["int8_norm_count"] = entry("int8_norm_count", *src["int8_norm_count"], e_err,
                                       e_times)
    torch.cuda.synchronize()


# the sharded unet_256's norm maps (B, H, W, C), whole: 2048^2 at level 1
# (the last upnorm, 1024^2 x 64) and level 2 (the first downnorm, 512^2 x
# 128), the largest a rank of (e) splits, and level 7 (16^2 x 512), its
# smallest; then (f)'s smallest, 512^2 at level 6 (8^2 x 512, two rows a
# shard of four)
UNET_SPLIT_SHAPES = ((1, 1024, 1024, 64), (1, 512, 512, 128), (1, 16, 16, 512))
UNET_SPLIT_FOUR = (1, 8, 8, 512)


def check_split_norm_unet(g: torch.Generator) -> None:
    """B's split forward at the sharded U-Net's norm shapes, without the
    ReLU and the skip (the U-Net fuses neither): over two shards, timed at
    shard 0's shape, and over four (the apply given four shards' pairs),
    and at (f)'s smallest over four.  The times go under ``unet_shapes`` of
    the two entries, the errors into their ``max_abs_err``."""
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    timed = {"instance_norm_sums": [], "instance_norm_apply": []}
    worst = {"sums": 0.0, "apply": 0.0}
    for shape in UNET_SPLIT_SHAPES:
        for name, (e, t) in check_split_norm(g, shape, row_ranges(shape[1], 2, 1, 1),
                                             relu=False).items():
            timed[name].append(times(*t))
            worst[name.split("_")[-1]] = max(worst[name.split("_")[-1]], e)
    for shape in UNET_SPLIT_SHAPES + (UNET_SPLIT_FOUR,):
        four = check_split_norm(g, shape, row_ranges(shape[1], 4, 1, 1), relu=False,
                                timed=False)
        worst = {k: max(v, four[k]) for k, v in worst.items()}
    for name, entries in timed.items():
        RESULTS[name]["unet_shapes"] = entries
        key = name.split("_")[-1]
        RESULTS[name]["max_abs_err"] = max(RESULTS[name]["max_abs_err"], worst[key])
    log("spatial", f"B's split forward at the U-Net's shard shapes, over two and four "
        f"shards: max errs {worst}")


# --------------------------------------- (e) layer by layer, and by row
@contextlib.contextmanager
def recorded_layers(net, sharded: bool):
    """The output of every k4 s2 conv, transposed conv and norm of the
    U-Net ``net`` while the block runs, as (name, output) in the order
    they run: ``forward``'s through module hooks; ``forward_rows``'s
    (``sharded``) through its conv and norm calls, each transposed conv's
    slab cropped to the shard's rows as ``forward_rows`` crops it."""
    from nirgan_tpu_torch.models import unet
    from nirgan_tpu_torch.models.layers import Norm, TorchConv, TorchConvTranspose

    names = {m: n for n, m in net.named_modules()}
    weights = {id(m.weight): n for m, n in names.items() if isinstance(m, TorchConv)}
    out = []

    def hook(m, args, y):
        if not sharded:
            out.append((names[m], y))
        elif isinstance(m, TorchConvTranspose):
            out.append((names[m], y[:, 2:y.shape[1] - 2]))

    handles = [m.register_forward_hook(hook) for m in names
               if isinstance(m, (TorchConv, TorchConvTranspose, Norm))]
    conv2d, norm_rows = unet.conv2d, unet._norm_rows

    def conv(x, w, b=None, stride=1, padding=0):
        y = conv2d(x, w, b, stride, padding)
        out.append((weights[id(w)], y))
        return y

    def norm(n, x, shard, count, relu=False, residual=None):
        y = norm_rows(n, x, shard, count, relu, residual)
        out.append((names[n], y))
        return y

    try:
        with mock.patch.object(unet, "conv2d", conv), \
                mock.patch.object(unet, "_norm_rows", norm):
            yield out
    finally:
        for h in handles:
            h.remove()


def parted(name: str, got: torch.Tensor, ref: torch.Tensor, row0: int) -> dict:
    """How a layer's rows ``got`` differ from ``ref`` (the same rows of the
    whole map's, which start at its row ``row0``): elements apart, max |d|
    and the first and last row of the map that differ."""
    d = (got.float() - ref.float()).abs()
    rows = torch.nonzero(d.amax(dim=(0, 2, 3))).flatten()
    return {"layer": name, "rows": [row0, row0 + got.shape[1]], "n_diff": int((d > 0).sum()),
            "max_abs": float(d.max()),
            "diff_rows": [row0 + int(rows[0]), row0 + int(rows[-1])] if len(rows) else None}


def layer_parts(task, rgb: np.ndarray, mesh) -> list:
    """(e) on this rank layer by layer: the sharded forward's output of
    every conv, transposed conv and norm against the same rows of the
    whole tile's forward in this process (no collective), in the order
    they run (``parted``)."""
    from nirgan_tpu_torch.parallel.spatial import predict_large_tile, shard_ranges

    with recorded_layers(task.netG, True) as mine:
        predict_large_tile(task, rgb, mesh)
    lo, _ = shard_ranges(task, rgb.shape[2], mesh.world_size)[mesh.rank]
    x = torch.from_numpy(np.ascontiguousarray(rgb.transpose(0, 2, 3, 1))).to(DEVICE)
    with recorded_layers(task.netG, False) as whole, torch.inference_mode():
        task.g_apply(x)
    if [n for n, _ in mine] != [n for n, _ in whole]:
        raise AssertionError(f"(e) layers: {[n for n, _ in mine]} vs {[n for n, _ in whole]}")
    out = []
    for (name, got), (_, ref) in zip(mine, whole):
        row0 = lo * ref.shape[1] // rgb.shape[2]
        out.append(parted(name, got, ref[:, row0:row0 + got.shape[1]], row0))
    return out


def cuda_kernels(fn) -> list:
    """The names of the kernels one call of ``fn`` runs on the card
    (``torch.profiler``)."""
    table, _ = profiled(lambda: (fn(), torch.cuda.synchronize()))
    return sorted(ev.key for ev in table if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not ev.is_user_annotation and ev.device_time_total)


def layers_alone(task, x: torch.Tensor, n: int = 2) -> list:
    """Every k4 s2 conv, transposed conv and instance norm of the U-Net,
    each on the input the whole map's forward gives it, against the same
    op as ``forward_rows`` runs it for each of ``n`` shards on that input:
    the conv on the shard's slab (one row of the neighbours or of zeros
    each side, a zero column each side; VALID at stride 2), the transposed
    conv on its slab cropped to rows [2, 2h + 2), B's split forward with
    every shard's sums.  So a layer that parts here parts on its own
    input, not by what an earlier layer handed on.  Per layer and shard
    ``parted``; for a conv or transposed conv that parts, the cuDNN kernels
    that ran for the whole map and for the shard's slab."""
    from nirgan_tpu_torch.models.layers import Norm, TorchConv, TorchConvTranspose
    from nirgan_tpu_torch.ops.conv import conv2d
    from nirgan_tpu_torch.ops.instance_norm import instance_norm_apply, instance_norm_sums
    from nirgan_tpu_torch.parallel.spatial import assemble, pad_cols, row_ranges, unet_depth

    names = {m: name for name, m in task.netG.named_modules()}
    side = x.shape[1]
    k = unet_depth(side, n, task.netG.num_downs)
    cuts = row_ranges(side, n, 1 << k, 1 << k)
    out = []

    def hook(m, args, y):
        # the shard's rows of the op's input map, at its level
        h = args[0]
        scale = h.shape[1] / side
        if isinstance(m, Norm):
            def split(i):
                a, b = int(cuts[i][0] * scale), int(cuts[i][1] * scale)
                return a, b, h[:, a:b].contiguous()
            pieces = [split(i) for i in range(n)]
            sums = torch.stack([instance_norm_sums(p) for _, _, p in pieces], 1)
            count = y.shape[1] * y.shape[2]
            for a, b, p in pieces:
                out.append(parted(names[m], instance_norm_apply(p, sums, count, 1e-5),
                                  y[:, a:b], a))
            return
        # the whole map between a zero row above and one below
        rows = assemble(h, None, None, 1, 1, "zero", True, True)
        for i, (lo, hi) in enumerate(cuts):
            a, b = int(lo * scale), int(hi * scale)
            slab = rows[:, a:b + 2]  # rows a - 1 ... b of the map
            if isinstance(m, TorchConv):
                def shard_op(slab=slab):
                    return conv2d(pad_cols(slab, 1, "zero"), m.weight, m.bias, stride=2)
                got, row0 = shard_op(), a // 2
            else:
                def shard_op(slab=slab):
                    return m.forward(slab)[:, 2:2 * (b - a) + 2]
                got, row0 = shard_op(), 2 * a
            entry = parted(names[m], got, y[:, row0:row0 + got.shape[1]], row0)
            if entry["n_diff"] and not any(e.get("kernels") for e in out):
                # the first op that parts: the kernels cuDNN ran for each shape
                entry["kernels"] = {"whole": cuda_kernels(lambda: m.forward(h)),
                                    "shard": cuda_kernels(shard_op)}
            out.append(entry)

    handles = [m.register_forward_hook(hook) for m in names
               if isinstance(m, (TorchConv, TorchConvTranspose))
               or (isinstance(m, Norm) and m.norm_type == "instance")]
    try:
        with torch.inference_mode():
            task.g_apply(x)
    finally:
        for h in handles:
            h.remove()
    return out


def summarise_parts(what: str, parts: list) -> dict:
    """Logs the layers of ``parts`` that part, and returns the count, the
    first that parts and the largest max |d|."""
    apart = [p for p in parts if p["n_diff"]]
    log("spatial", f"{what}: {len(apart)} of {len(parts)} layer results part; the first "
        f"{apart[0] if apart else None}")
    for p in apart[:12]:
        log("spatial", f"    {p['layer']} rows {p['rows']}: {p['n_diff']} elements apart, "
            f"max|d| {p['max_abs']:.3e}, rows {p['diff_rows']}")
    return {"layers": len(parts), "parted": len(apart),
            "first": apart[0] if apart else None,
            "max_abs": max((p["max_abs"] for p in parts), default=0.0)}


def rows_apart(pred: np.ndarray, ref: np.ndarray, boundary: int) -> dict:
    """(e)'s |d| against one process row by row over the output's rows: how
    many rows differ, how many of them lie within 16 rows of the shards'
    boundary, the largest |d| in each band of 128 rows, and the rows
    differing at a multiple of 2^l for l = 1 ... 8."""
    d = np.abs(pred - ref)[0, 0].max(axis=1)
    rows = np.flatnonzero(d)
    bands = [float(d[i:i + 128].max()) for i in range(0, len(d), 128)]
    return {"rows": int(len(d)), "rows_apart": int(len(rows)),
            "near_boundary": int(np.sum(np.abs(rows - boundary) <= 16)),
            "band_max": bands,
            "on_multiples": {1 << l: int(np.sum(rows % (1 << l) == 0)) for l in range(1, 9)}}


def phase_spatial(tmp: str) -> dict:
    """The H-sharded tile (``nirgan_tpu_torch/parallel/spatial.py``) on the
    one card, processes sharing it over gloo:

    (a) ``config_px2px.yaml`` (resnet_9blocks, ngf 64, pad 10) in bf16, one
        seeded 2048^2 tile: two ranks' ``predict_large_tile`` against one
        process's ``g_apply`` of the whole tile, >= 40 dB (only the
        statistics' summation order differs); each rank's wrapper calls (A
        in VALID mode 18, B's sums and apply 23 each, C 1; A's reflect mode,
        B's one call and the library routes 0), its peak device memory and
        its forward's ms by CUDA events beside the one process's;
    (b) the int8 trunk on the same tile, calibrated once by the one process
        and handed to the ranks: JAX's bounds (max |d| < 0.1, > 40 dB against
        the one-process int8 forward, not equal to (a)'s float output), D
        VALID 18 and E 19 a rank; then stage 2 against one process's stage-2
        forward, >= 40 dB;
    (c) f32 with TF32 off, a 512^2 tile, the reflect, replicate and zero
        trunks: two ranks each within max |d| <= 1e-4 of one process; then
        one process under ``torch.distributed.run`` over NCCL (world size 1,
        its collectives run) within the same bound;
    (d) the (2, 2) grid, four ranks over gloo, batch 2 of 512^2 in bf16,
        against one process, >= 40 dB;
    (e) ``unet_256`` (ngf 64, instance norm, unpadded) in bf16 on (a)'s
        2048^2 tile over two ranks (sharded to level 8: nothing gathered)
        against one process, >= 40 dB, bit for bit or not; each rank's
        wrapper calls (B's sums and apply 13 each, B's one call 0, no
        library route), peak device memory and forward ms beside one
        process's; where it parts: its |d| by output row, each conv,
        transposed conv and norm of each rank against the same rows of the
        whole tile's forward, each of those layers alone on its own input
        (``layers_alone``, also on (h)'s first 512^2 sample); and (e) in f32
        with TF32 off within max |d| <= 1e-4 of one process;
    (f) the U-Net in f32 with TF32 off on (c)'s 512^2 tile over four ranks
        (sharded to level 7: the innermost block on the gathered 4^2 map,
        B's one call once a rank) within max |d| <= 1e-4 of one process;
        then the one process under ``torch.distributed.run`` over NCCL;
    (g) pix2pix's batch-norm U-Net (eval mode), bf16, (e)'s tile over two
        ranks, >= 40 dB;
    (h) the U-Net on (d)'s (2, 2) grid and batch, >= 40 dB.

    The grid's four ranks run first, then the two ranks, so that no rank's
    forward is timed beside another spawn's.  The times are a baseline
    only: processes sharing one card over gloo, whose collectives go
    through the host, are not a measurement of spatial parallelism across
    cards."""
    from nirgan_tpu_torch.parallel.spatial import row_ranges

    folder = os.path.join(tmp, "spatial")
    os.makedirs(folder)
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with cudnn_tf32(False):
        spatial_kernel_checks(g)
    kernels_s = time.perf_counter() - t0

    def nhwc(rgb):
        return torch.from_numpy(np.ascontiguousarray(rgb.transpose(0, 2, 3, 1))).to(DEVICE)

    def nchw(y):
        return y.float().permute(0, 3, 1, 2).cpu().numpy()

    # the one process's references; a peak counts from what the process
    # held before the task and the tile (earlier phases leave tensors
    # behind), as a rank's counts from its start
    base = torch.cuda.memory_allocated()
    task = spatial_task()
    x = nhwc(spatial_tile(SPATIAL_SIDE))
    with torch.inference_mode():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one = nchw(task.g_apply(x))
        one_peak = torch.cuda.max_memory_allocated() - base
        one_ms = time_ms(lambda: task.g_apply(x), iters=3, warmup=1)
        packs = {"int8": task.build_trunk_q(x), "stage2": task.build_trunk_q(x, stage2=True)}
        one8 = {k: nchw(task.g_apply(x, trunk_q=p)) for k, p in packs.items()}
    for k, p in packs.items():
        torch.save(p, os.path.join(folder, f"{k}.pt"))
    rgb32 = spatial_tile(SPATIAL_F32_SIDE, 1, SEED + 1)
    with cudnn_tf32(False), torch.inference_mode():
        one32 = {trunk: nchw(spatial_task("float32", trunk).g_apply(nhwc(rgb32)))
                 for trunk in SPATIAL_TRUNKS}
    batch = spatial_tile(SPATIAL_F32_SIDE, SPATIAL_GRID_BATCH, SEED + 2)
    with torch.inference_mode():
        one_grid = nchw(task.g_apply(nhwc(batch)))
    del task, packs
    torch.cuda.empty_cache()
    # (e)-(h)'s one process
    unet = {}
    del x
    base = torch.cuda.memory_allocated()
    task = spatial_unet_task()
    x = nhwc(spatial_tile(SPATIAL_SIDE))
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        unet["e"] = nchw(task.g_apply(x))
        unet["e_peak"] = torch.cuda.max_memory_allocated() - base
        unet["e_ms"] = time_ms(lambda: task.g_apply(x), iters=3, warmup=1)
        unet["h"] = nchw(task.g_apply(nhwc(batch)))
        unet["g"] = nchw(spatial_unet_task(norm="batch").g_apply(x))
    with cudnn_tf32(False), torch.inference_mode():
        unet["f"] = nchw(spatial_unet_task("float32").g_apply(nhwc(rgb32)))
        unet["e32"] = nchw(spatial_unet_task("float32").g_apply(x))
    del task, x
    torch.cuda.empty_cache()

    # (d), (h) and (f) on four ranks, then (e), (g) and (a)-(c) on two
    def ranks(part, n):
        return [[sys.executable, "-c", SPATIAL_RANK, ROOT, folder,
                 os.path.join(folder, f"rendezvous_{part}"), str(r), str(n), part]
                for r in range(n)]

    t1 = time.perf_counter()
    run_processes(ranks("grid", 4), 600, "the spatial grid's ranks")
    run_processes(ranks("two", 2), 600, "the spatial ranks")
    ranks_s = time.perf_counter() - t1
    rank_file = os.path.join(folder, "rank.py")
    with open(rank_file, "w") as f:
        f.write(SPATIAL_RANK)
    t1 = time.perf_counter()
    run_processes([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "1", rank_file, ROOT, folder, "-", "0", "1", "nccl"]],
                  300, "the spatial rank under torchrun")
    nccl_s = time.perf_counter() - t1
    two = [torch.load(os.path.join(folder, f"two{r}.pt"), weights_only=False) for r in range(2)]
    grid = [torch.load(os.path.join(folder, f"grid{r}.pt"), weights_only=False)
            for r in range(4)]
    nccl = torch.load(os.path.join(folder, "nccl0.pt"), weights_only=False)

    def same(key, results, sub="pred"):
        first = results[0][key] if sub is None else results[0][key][sub]
        return all(np.array_equal(first, r[key] if sub is None else r[key][sub])
                   for r in results[1:]), first

    def apart(a, b):
        return float(np.abs(a - b).max()), psnr(torch.from_numpy(a), torch.from_numpy(b), 2.0)

    # (a)
    equal, pred = same("a", two)
    err, db = apart(pred, one)
    want = row_ranges(SPATIAL_SIDE + 2 * PAD, 2)
    launches = [r["a"]["launches"] for r in two]
    log("spatial", f"(a) bf16 {SPATIAL_SIDE}^2 tile, two ranks over gloo (rows "
        f"{[r['a']['rows'] for r in two]}) vs one process: {db:.2f} dB (bound 40), max|d| "
        f"{err:.3e}; equal on both ranks {equal}; wrapper calls a rank {launches}; peak "
        f"device memory a rank {[r['a']['peak'] for r in two]} B, one process {one_peak} B; "
        f"forward ms a rank (CUDA events) {[round(r['a']['ms'], 3) for r in two]}, one "
        f"process {one_ms:.3f}")
    if not (pred.shape == (1, 1, SPATIAL_SIDE, SPATIAL_SIDE) and np.isfinite(pred).all()
            and db >= 40.0 and equal and [r["a"]["rows"] for r in two] == want):
        raise AssertionError(f"(a) spatial bf16: {pred.shape}, {db}, {equal}")
    for got in launches:
        if {k: got[k] for k in SPATIAL_FORWARD} != SPATIAL_FORWARD or got["library"]:
            raise AssertionError(f"(a) a rank's wrapper calls {got}, want {SPATIAL_FORWARD}")
    # (b)
    equal8, pred8 = same("int8", two)
    err8, db8 = apart(pred8, one8["int8"])
    equal2, pred2 = same("stage2", two)
    err2, db2 = apart(pred2, one8["stage2"])
    l8, l2 = two[0]["int8"]["launches"], two[0]["stage2"]["launches"]
    log("spatial", f"(b) int8 trunk, two ranks vs one process: {db8:.2f} dB (bound 40), "
        f"max|d| {err8:.3e} (bound 0.1), equal to (a)'s float output "
        f"{np.array_equal(pred8, pred)}; stage 2: {db2:.2f} dB (bound 40), max|d| {err2:.3e}; "
        f"equal on both ranks {equal8}, {equal2}; D and E a rank: int8 "
        f"{l8['int8_conv']} {l8['int8_norm']}, stage 2 {l2['int8_conv']} {l2['int8_norm']}")
    if not (err8 < 0.1 and db8 > 40.0 and not np.array_equal(pred8, pred) and db2 >= 40.0
            and equal8 and equal2 and l8["int8_conv"] == {"valid s1": 18}
            and l2["int8_conv"] == {"valid s1": 18, "valid s2": 1}
            and sum(l8["int8_norm"].values()) == 19 and l8["instance_norm_sums"] == 5):
        raise AssertionError(f"(b) spatial int8: {err8}, {db8}, {db2}, {l8}, {l2}")
    # (c)
    f32 = {}
    for tag, results in (("two ranks", two), ("torchrun nccl", [nccl])):
        for trunk in SPATIAL_TRUNKS:
            eq, got = same("f32", results, trunk)
            f32[f"{tag} {trunk}"] = float(np.abs(got - one32[trunk]).max())
            if not (eq and f32[f"{tag} {trunk}"] <= 1e-4):
                raise AssertionError(f"(c) f32 {tag} {trunk}: {f32[f'{tag} {trunk}']}, {eq}")
    log("spatial", f"(c) f32 {SPATIAL_F32_SIDE}^2, TF32 off, max|d| vs one process (bound "
        f"1e-4): {f32}; under torchrun: backend {nccl['backend']}, world {nccl['world']}")
    if nccl["backend"] != "nccl" or nccl["world"] != 1:
        raise AssertionError(f"(c) torchrun: {nccl['backend']}, {nccl['world']}")
    # (d)
    equal_g, pred_g = same("grid", grid, None)
    err_g, db_g = apart(pred_g, one_grid)
    log("spatial", f"(d) ({SPATIAL_GRID[0]}, {SPATIAL_GRID[1]}) grid, four ranks, batch "
        f"{SPATIAL_GRID_BATCH} of {SPATIAL_F32_SIDE}^2 bf16 vs one process: {db_g:.2f} dB "
        f"(bound 40), max|d| {err_g:.3e}; equal on every rank {equal_g}; wrapper calls a "
        f"rank {grid[0]['launches']}")
    if not (db_g >= 40.0 and equal_g and pred_g.shape == one_grid.shape):
        raise AssertionError(f"(d) spatial grid: {db_g}, {equal_g}")
    unet_out = check_spatial_unet(unet, two, grid, nccl, same, apart)
    log("spatial", f"kernel checks {kernels_s:.1f} s, the ranks {ranks_s:.1f} s, torchrun "
        f"{nccl_s:.1f} s, the phase {time.perf_counter() - t0:.1f} s")

    def finite(v):  # JSON has no infinity: bit for bit reads null
        return v if math.isfinite(v) else None

    return {"db": finite(db), "max_abs": err, "int8_db": finite(db8), "int8_max_abs": err8,
            "stage2_db": finite(db2), "stage2_max_abs": err2, "f32_max_abs": f32,
            "grid_db": finite(db_g), "grid_max_abs": err_g,
            "peak_bytes": [r["a"]["peak"] for r in two], "one_peak_bytes": one_peak,
            "ms": [r["a"]["ms"] for r in two], "one_ms": one_ms,
            "launches": launches[0], "int8_launches": l8, "stage2_launches": l2,
            "unet": {k: finite(v) if k.endswith("db") else v for k, v in unet_out.items()}}


def unet_norm_calls(got: dict) -> dict:
    return {k: got[k] for k in UNET_SPATIAL_NORMS}


def check_spatial_unet(one: dict, two: list, grid: list, nccl: dict, same, apart) -> dict:
    """(e)-(h) of ``phase_spatial``: the ranks' results against the one
    process's (``one``), each rank's wrapper calls; the numbers for the
    JSON line."""
    # (e)
    equal, pred = same("e", two)
    err, db = apart(pred, one["e"])
    launches = [r["e"]["launches"] for r in two]
    log("spatial", f"(e) unet_256 bf16 {SPATIAL_SIDE}^2 tile, two ranks over gloo (rows "
        f"{[r['e']['rows'] for r in two]}) vs one process: {db:.2f} dB (bound 40), max|d| "
        f"{err:.3e}, bit for bit {bool(np.array_equal(pred, one['e']))}; equal on both ranks "
        f"{equal}; wrapper calls a rank {launches}; peak device memory a rank "
        f"{[r['e']['peak'] for r in two]} B, one process {one['e_peak']} B; forward ms a "
        f"rank (CUDA events) {[round(r['e']['ms'], 3) for r in two]}, one process "
        f"{one['e_ms']:.3f}")
    if not (pred.shape == (1, 1, SPATIAL_SIDE, SPATIAL_SIDE) and np.isfinite(pred).all()
            and db >= 40.0 and equal):
        raise AssertionError(f"(e) spatial unet bf16: {pred.shape}, {db}, {equal}")
    for got in launches:
        if unet_norm_calls(got) != UNET_SPATIAL_LEVEL8 or got["library"]:
            raise AssertionError(f"(e) a rank's wrapper calls {got}, want "
                                 f"{UNET_SPATIAL_LEVEL8} and no library route")
    # where (e) parts from one process: by row, layer by layer on each rank,
    # each layer alone on its own input (2048^2, and 512^2 where (h) is bit
    # for bit), and in f32
    by_row = rows_apart(pred, one["e"], SPATIAL_SIDE // 2)
    log("spatial", f"(e) |d| by output row: {by_row['rows_apart']} of {by_row['rows']} rows "
        f"apart, {by_row['near_boundary']} of them within 16 rows of the boundary (row "
        f"{SPATIAL_SIDE // 2}); rows apart on multiples of 2^l {by_row['on_multiples']}; "
        f"max|d| by band of 128 rows {[f'{v:.1e}' for v in by_row['band_max']]}")
    chained = [summarise_parts(f"(e) rank {r}, each layer against the same rows of the "
                               "whole tile's forward", rk["e"]["layers"])
               for r, rk in enumerate(two)]
    alone = {side: summarise_parts(f"each layer alone on its own input, {side}^2 over two "
                                   "shards", parts) for side, parts in two[0]["alone"].items()}
    equal32, pred32 = same("e32", two, None)
    err32 = float(np.abs(pred32 - one["e32"]).max())
    log("spatial", f"(e) in f32, TF32 off, two ranks vs one process: max|d| {err32:.3e} "
        f"(bound 1e-4); equal on both ranks {equal32}")
    if not (equal32 and err32 <= 1e-4 and pred32.shape == one["e32"].shape):
        raise AssertionError(f"(e) f32: {err32}, {equal32}")
    # (f)
    f32 = {}
    for tag, results, want in (("four ranks", grid, UNET_SPATIAL_LEVEL7),
                               ("torchrun nccl", [nccl], UNET_SPATIAL_LEVEL8)):
        eq, got = same("f", results)
        f32[tag] = float(np.abs(got - one["f"]).max())
        calls = [unet_norm_calls(r["f"]["launches"]) for r in results]
        if not (eq and f32[tag] <= 1e-4 and all(c == want for c in calls)
                and not any(r["f"]["launches"]["library"] for r in results)):
            raise AssertionError(f"(f) unet f32 {tag}: {f32[tag]}, {eq}, {calls}")
    log("spatial", f"(f) unet_256 f32 {SPATIAL_F32_SIDE}^2, TF32 off, max|d| vs one process "
        f"(bound 1e-4): {f32}; B a rank of four {unet_norm_calls(grid[0]['f']['launches'])}")
    # (g)
    equal_g, pred_g = same("g", two)
    err_g, db_g = apart(pred_g, one["g"])
    calls_g = [unet_norm_calls(r["g"]["launches"]) for r in two]
    log("spatial", f"(g) batch-norm unet_256 bf16 {SPATIAL_SIDE}^2, two ranks vs one "
        f"process: {db_g:.2f} dB (bound 40), max|d| {err_g:.3e}; equal on both ranks "
        f"{equal_g}; forward ms a rank {[round(r['g']['ms'], 3) for r in two]}")
    if not (db_g >= 40.0 and equal_g and all(c == UNET_SPATIAL_BATCH for c in calls_g)):
        raise AssertionError(f"(g) spatial batch-norm unet: {db_g}, {equal_g}, {calls_g}")
    # (h)
    equal_h, pred_h = same("h", grid)
    err_h, db_h = apart(pred_h, one["h"])
    calls_h = [unet_norm_calls(r["h"]["launches"]) for r in grid]
    log("spatial", f"(h) unet_256 on the ({SPATIAL_GRID[0]}, {SPATIAL_GRID[1]}) grid, batch "
        f"{SPATIAL_GRID_BATCH} of {SPATIAL_F32_SIDE}^2 bf16 vs one process: {db_h:.2f} dB "
        f"(bound 40), max|d| {err_h:.3e}; equal on every rank {equal_h}; B a rank {calls_h}")
    if not (db_h >= 40.0 and equal_h and pred_h.shape == one["h"].shape
            and all(c == UNET_SPATIAL_LEVEL8 for c in calls_h)):
        raise AssertionError(f"(h) spatial unet grid: {db_h}, {equal_h}, {calls_h}")
    return {"db": db, "max_abs": err, "bit_for_bit": bool(np.array_equal(pred, one["e"])),
            "peak_bytes": [r["e"]["peak"] for r in two], "one_peak_bytes": one["e_peak"],
            "ms": [r["e"]["ms"] for r in two], "one_ms": one["e_ms"],
            "launches": launches[0], "four_rank_launches": grid[0]["f"]["launches"],
            "f32_max_abs": f32, "batch_norm_db": db_g, "batch_norm_max_abs": err_g,
            "batch_norm_ms": [r["g"]["ms"] for r in two], "grid_db": db_h,
            "grid_max_abs": err_h, "by_row": by_row, "layers": chained, "alone": alone,
            "f32_2048_max_abs": err32}


def alone_native() -> None:
    phase_native()
    phase_native_profile()


def alone_ddp() -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_ddp(tmp)


def alone_int8() -> None:
    """Kernels D and E in every gather and mode, then the int8 forwards."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with cudnn_tf32(False):
        phase_int8_kernels(g)
        phase_int8_gathers(g)
    for kw in ({}, {"stage2": True}, {"padding": "replicate"}, {"padding": "zero"}):
        phase_int8_serving(**kw)


def alone_train() -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_train(tmp)
        phase_train(tmp, satclip=True)


# ``python3 chip_smoke.py --phase NAME ...``: after the device and build
# phases, only the named phases, in order (no JSON lines): a phase's checks
# read alone, without what the phases before it leave set
def alone_train512() -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_train512(tmp)


def alone_unet() -> None:
    for netg in UNET_CALLS:
        phase_unet(netg)


def alone_export() -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_export(tmp)


def alone_spatial() -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_spatial(tmp)


ALONE = {"int8": alone_int8, "train": alone_train, "variants": phase_variants,
         "nonsquare": phase_nonsquare, "param_dtype": phase_param_dtype,
         "export": alone_export, "native": alone_native, "ddp": alone_ddp,
         "spatial": alone_spatial, "train512": alone_train512, "unet": alone_unet,
         "reflect_pad": phase_reflect_pad, "profiler": alone_profiler}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    other = sys.argv[1:2] in (["--times"], ["--split"])
    if other:
        # the package of another checkout (a parent commit's), ahead of this one
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
    import nirgan_tpu_torch  # noqa: F401  (fail before printing anything)

    os.chdir(ROOT)  # the training CLI's default configs are relative paths

    device = phase_device()
    phase_build(instructions=not other)
    if sys.argv[1:] == ["--profile"]:
        phase_profile()
        return
    if sys.argv[1:] == ["--sweep"]:
        phase_sweep()
        return
    if sys.argv[1:2] == ["--phase"]:
        for name in sys.argv[2:]:
            ALONE[name]()
        return
    if sys.argv[1:2] == ["--times"]:
        phase_times()
        return
    if sys.argv[1:2] == ["--split"]:
        phase_split(sys.argv[3:] or ["D", "E"])
        return
    phase_kernels()
    per_forward = phase_generator()
    sat_forward = phase_generator(satclip=True)
    int8_forward = phase_int8_serving()
    sat_int8_forward = phase_int8_serving(satclip=True)
    stage2_forward = phase_int8_serving(stage2=True)
    padded_int8 = {p: phase_int8_serving(padding=p) for p in ("replicate", "zero")}
    phase_scene()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        exports = phase_export(tmp)
        phase_scene_cli(tmp)
        serving = phase_serving(tmp)
        sat_serving = phase_serving(tmp, SATCLIP_CONFIG, "serving, inject")
        int8_serving = phase_serving(tmp, CONFIG, "serving, int8", quant="int8")
        launches, per_step = phase_train(tmp)
        sat_launches, sat_step = phase_train(tmp, satclip=True)
        train512 = phase_train512(tmp)
    phase_aux_step()
    phase_ngf16()
    phase_concat()
    phase_nonsquare()
    bf16_params = phase_param_dtype()
    unet = phase_unet()
    unet128 = phase_unet("unet_128")
    phase_pix2pix()
    pad0 = phase_variants()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_baselines(tmp)
        pretrain = phase_satclip_pretrain(tmp)
        validation = phase_validation(tmp)
    native = phase_native()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ddp = phase_ddp(tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        spatial = phase_spatial(tmp)
    phase_norm_launches()
    phase_host_waits()
    phase_pretrain_profile(pretrain)
    del pretrain
    native["profile"] = phase_native_profile()
    if min(launches.values()) == 0 or min(sat_launches.values()) == 0:
        raise AssertionError(f"a kernel of the training path was not launched: "
                             f"{launches}, {sat_launches}")
    entries = []
    for name in STEP_LAUNCHES:
        kernel = {**RESULTS[name], "launches": launches[name],
                  "per_step": per_step[name],
                  "satclip": {"launches": sat_launches[name],
                              "per_step": sat_step[name]}}
        # the 10980^2 scene's run (625 windows in batches of 32)
        kernel["scene"] = {"launches": SCENE["bf16"][name], "windows": SCENE["windows"],
                           "batch": SCENE_BATCH}
        if name in SERVING_KERNELS:
            kernel["validation"] = validation_entry(validation["bf16"], name)
            kernel["serving"]["launches"] = serving[name]
            kernel["serving"]["per_forward"] = per_forward[name]
            kernel["satclip"]["serving_launches"] = sat_serving[name]
            kernel["satclip"]["per_forward"] = sat_forward[name]
        entries.append(kernel)
        if name in ("instance_norm", "instance_norm_bwd"):
            # the unet_256 forward (4 x 512^2) and step (batch 16 of 256^2)
            kernel["unet"] = {"launches": unet["per_step"][name],
                              "per_forward": unet["per_forward"][name],
                              "per_step": unet["per_step"][name]}
            kernel["unet_128"] = {"per_forward": unet128["per_forward"][name],
                                  "per_step": unet128["per_step"][name]}
        # one fused step of the 512^2 training configuration
        kernel["train512_step"] = {"per_step": train512["per_step"][name]}
    # the trunk backward's pad and adjoint: times at the 532^2 and 276^2
    # steps' trunk shapes beside the byte bound, launches in a 532^2 step
    for name in PAD_STEP_LAUNCHES:
        at532, at276 = train512["reflect_pad"][name]
        entries.append({**at532, "name": name, "route": "cuda",
                        "source": "nirgan_tpu_torch/csrc/reflect_pad.cu",
                        "replaces": "XLA's pad and its transpose in the trunk's backward",
                        "max_abs_err": 0.0, "train276": at276,
                        "train512_step": {"per_step": train512["pads_per_step"][name],
                                          "want": PAD_STEP_LAUNCHES[name]}})
    # A's VALID mode (conv3x3_pallas): the replicate and zero trunks, a
    # serving forward and a step each
    a = RESULTS["trunk_conv"]
    entries.append({**a["pad0"], "name": "trunk_conv_pad0", "route": "cuda",
                    "source": a["source"], "max_abs_err": a["max_abs_err"],
                    "launches": sum(v["launches"] for v in pad0.values()),
                    "per_step": pad0["zero"]["per_step"],
                    "per_forward": pad0["zero"]["per_forward"], "trunks": pad0,
                    "serving": a["pad0_serving"]})
    # D and E: launches in the int8 serving CLI's run (two batches of 4)
    for name in INT8_FORWARD:
        kernel = {**RESULTS[name], "launches": int8_serving[name],
                  "per_forward": int8_forward[name],
                  "satclip": {"per_forward": sat_int8_forward[name]},
                  # the 3000 x 4000 scene with the int8 trunk (2 batches)
                  "scene": {"launches": SCENE["int8"][name],
                            "windows": scene_windows(SCENE_H, SCENE_W),
                            "batch": SCENE_BATCH},
                  "validation": validation_entry(validation["int8"], name)}
        entries.append(kernel)
    # D's other gathers and E's mode 3, each a kernel entry of its own: the
    # launches in the int8 forward that runs it (stage 2; the replicate and
    # zero trunks), the times at the serving shapes (phase_int8_gathers)
    gathers, d = RESULTS["int8_conv_gathers"], RESULTS["int8_conv"]
    for key, tag, route, line in (
            ("replicate", "int8 serving, replicate trunk", "replicate s1", 149),
            ("zero", "int8 serving, zero trunk", "zero s1", 149),
            ("stride2", "int8 serving, stage 2", "zero s2", 130)):
        n = INT8_ROUTES[tag]["int8_conv"][route]
        entries.append({**gathers[key], "name": f"int8_conv_{key}", "route": "cuda",
                        "source": d["source"], "max_abs_err": gathers["max_abs_err"],
                        "replaces": f"nirgan_tpu/ops/int8_trunk.py:{line}",
                        "launches": n, "per_forward": n, "note": gathers["note"]})
    n = INT8_ROUTES["int8 serving, stage 2"]["int8_norm"]["mode 3"]
    entries.append({**RESULTS["int8_norm"]["mode3"], "name": "int8_norm_mode3",
                    "route": "cuda", "source": RESULTS["int8_norm"]["source"],
                    "replaces": "nirgan_tpu/ops/int8_trunk.py:139",
                    "launches": n, "per_forward": n})
    # the H-sharded tile's entry points, each with its wrapper calls a rank
    # in one sharded forward: B's split forward in (a), D's VALID gathers
    # and E with the tile's count in (b) and stage 2
    sl, s8, s2 = spatial["launches"], spatial["int8_launches"], spatial["stage2_launches"]
    for name, n in (("instance_norm_sums", sl["instance_norm_sums"]),
                    ("instance_norm_apply", sl["instance_norm_apply"]),
                    ("int8_conv_valid", s8["int8_conv"]["valid s1"]),
                    ("int8_conv_stride2_valid", s2["int8_conv"]["valid s2"]),
                    ("int8_norm_count", s8["int8_norm"]["mode 1"] + s8["int8_norm"]["mode 2"])):
        entries.append({**RESULTS[name], "launches": n, "per_forward": n,
                        "path": "spatial, a rank's sharded forward"})
    for kernel in entries:
        if kernel["name"] in ("trunk_conv_pad0", "head_conv"):
            kernel["spatial"] = {"per_rank_forward": sl[kernel["name"]]}
        if kernel["name"] in UNET_SPATIAL_NORMS:
            # the sharded unet_256: a rank of (e) (2048^2 over two) and of
            # (f) (512^2 over four, the innermost block gathered)
            kernel["spatial_unet"] = {
                "per_rank_forward": spatial["unet"]["launches"][kernel["name"]],
                "per_rank_forward_four": spatial["unet"]["four_rank_launches"][kernel["name"]]}
    # B and B4 under gradient_penalty; the bf16-parameter step; the
    # exported serving programs' launches a forward
    for kernel in entries:
        if kernel["name"] in EXPORT_KERNELS["int8"]:
            kernel["export"] = {tag: exports[tag]["launches"][kernel["name"]]
                                for tag, _, _ in EXPORTS}
        if kernel["name"] in ("instance_norm", "instance_norm_bwd"):
            kernel["gradient_penalty"] = {what: launched[kernel["name"]]
                                          for what, launched in PENALTY_LAUNCHES.items()}
        if kernel["name"] in STEP_LAUNCHES:
            kernel["bf16_params"] = {"per_step": bf16_params["per_step"][kernel["name"]]}
    print(json.dumps({"kernels": entries, "stage2": STAGE2,
                      "export": {tag: {k: v for k, v in exports[tag].items()
                                       if k != "launches"} for tag, _, _ in EXPORTS},
                      "host_us": exports["host_us"], "native": native, "ddp": ddp,
                      "spatial": spatial,
                      "train512": {k: v for k, v in train512.items() if k != "per_step"},
                      "bf16_params": {k: v for k, v in bf16_params.items()
                                      if k != "per_step"}}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
