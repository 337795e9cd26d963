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
   not, and at odd shapes on either side of its two regimes).  The trunk conv is timed in both pad modes.  The
   instance norm is timed over a rotation of inputs larger than the L2
   cache (``ms``) and on one input (``warm_ms``).  The trunk conv and the
   transposed conv's backward are also held at a shape that their wgmma
   kernels do not take, where the WMMA kernels run.
3. generator: the full-width ``resnet_9blocks`` (ngf 64), random weights
   from a seed, batch 4 at 532^2 in bf16: kernel path against the plain
   path, launches per forward, forward time; then ``predict_step`` in f32
   on the card against the same task on the CPU.  Twice: the plain
   generator, then the SatCLIP inject generator with embeddings and
   ``predict_step`` with coordinates.
4. serving: ``python -m nirgan_tpu_torch.create_synthetic_dataset`` on 8
   seeded uint16 tiles (HR 512^2 3-band, LR 128^2 4-band, coordinates)
   with ``--device cuda --batch-size 4``; launch counts of that run,
   output checks, agreement with the plain path, and tiles/s of a warm
   rerun of the CLI.  Twice: ``config_px2px.yaml``, then
   ``config_px2px_SatCLIP.yaml``.
5. train: one fused GAN step of the full-width config in bf16 on the
   kernels against the plain route, launches per step, a finite non-zero
   gradient for every parameter, the same gradients bit for bit from a
   second run of the seeded step, step times, bare and with
   ``extract_batch`` (the batch's copies; the SatCLIP tower in line and
   ahead of time, as the trainer's loader thread runs it); an f32 step on
   the card
   against the same seeded step on the CPU at a small config; then
   ``python -m nirgan_tpu_torch.train`` for 8 steps on the fake data
   (``last`` and ``best``) and a resume for 2 more.  Twice:
   ``config_px2px.yaml`` (batch 16 at 256^2), then the flagship
   ``config_px2px_SatCLIP.yaml`` (inject, batch 8 at 256^2) with the CLI's
   default arguments.  Then the concat route (6 blocks): one forward and
   one step, kernels against the plain route.
6. launches: one call of the instance norm at each timed shape under
   ``torch.profiler``: one kernel where the plan is resident, two where it
   streams.  Last, since an attached profiler slows the host's launches.

``python3 chip_smoke.py --profile`` instead prints, after phases 0 and 1,
the device time of the serving forward and of the train step by group of
kernels under ``torch.profiler``, on the plain and on the inject route, and
the head's backward on its own (no checks, no ``ok`` line).
``python3 chip_smoke.py --sweep`` instead times the instance norm under
every launch plan its kernels take at the main path's shapes, beside the
plan that ``launch_plan`` chooses.

Before the last line it prints one JSON object with every kernel's route,
source, launches in the training CLI's run (``per_step``: in one fused
step), error, and times and bound at the train step's ``shape``; a forward
kernel's ``serving`` entry holds the serving path's shape, times, bound and
launches (``per_forward``: in one generator forward); every kernel's
``satclip`` entry holds its launches on the SatCLIP inject route (the
training CLI's default run, one step, the serving CLI, one forward) and its
``satclip_step`` entry (``satclip_u1`` / ``satclip_u0`` for the transposed
conv's backward) its times, bound and plan at that route's batch of 8; the
head's entries state the kernel that ran, the time of the f32-FMA kernel it
replaced (``old_ms``), the two-call library route and ``share`` =
``bound_ms / ms``; the trunk conv's
``pad0`` entries hold its times on a pre-padded input; the instance norm's
entries state their launch plan (``regime``, ``cluster``, ``smem_bytes``)
and the kernels that one call launched on the card under ``torch.profiler``
(``cuda_launches``), and list every main-path shape under ``shapes``,
the forward also with the skip fused (``with_skip``), the backward also
without the fused ReLU (``no_relu``, beside the library call).  The last
line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import os
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
# published peaks of one H100 SXM: dense bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
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


def least_time(flops: float, moved: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the bf16 tensor-core peak and the bytes that must
    move (each input read once, each output written once) over the memory
    rate."""
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
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


def reset_counts() -> None:
    for fn in kernels().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors to the plain versions instead of the kernels, to
    compare whole paths (the package itself has no such switch)."""
    from nirgan_tpu_torch.ops import convt_bwd, head_conv, instance_norm, trunk_conv

    with mock.patch.object(trunk_conv, "trunk_conv_cuda",
                           trunk_conv.trunk_conv_plain), \
         mock.patch.object(instance_norm, "instance_norm_cuda",
                           instance_norm.instance_norm_plain), \
         mock.patch.object(instance_norm, "instance_norm_bwd_cuda",
                           instance_norm.instance_norm_bwd_plain), \
         mock.patch.object(head_conv, "head_conv_cuda",
                           head_conv.head_conv_plain), \
         mock.patch.object(convt_bwd, "convt_k3s2_bwd_cuda",
                           convt_bwd.convt_k3s2_bwd_plain):
        yield


def psnr(a: torch.Tensor, b: torch.Tensor, peak_to_peak: float) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak_to_peak ** 2 / mse)


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    log("device", f"{dev['kind']} x{dev['count']}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return dev


def phase_build() -> None:
    from nirgan_tpu_torch.ops import _lib

    path, seconds, report = _lib.build()
    _lib.library()
    log("build", f"{path.name} built in {seconds:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())
    spills = [line for line in report.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")
    # the redesigned kernels must reach the tensor cores through wgmma:
    # HGMMA is its machine instruction
    dump = subprocess.run(
        [os.path.join(os.path.dirname(_lib.nvcc()), "cuobjdump"), "-sass", str(path)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    per_kernel, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and ("HGMMA" in line or "HMMA." in line):
            key = (name, "HGMMA" if "HGMMA" in line else "HMMA")
            per_kernel[key] = per_kernel.get(key, 0) + 1
    found = {f"{want} {op}": sum(v for (k, o), v in per_kernel.items()
                                 if want in k and o == op)
             for want, op in (("igemm_wgmma_kernelILi256", "HGMMA"),
                              ("igemm_wgmma_kernelILi128", "HGMMA"),
                              ("convt_dw_wgmma_kernel", "HGMMA"),
                              # the head's mma.sync is HMMA.16816
                              ("head_conv_mma_kernel", "HMMA"))}
    log("build", f"tensor-core instructions (wgmma = HGMMA, mma.sync = HMMA): {found}")
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


def check_norm(x: torch.Tensor, relu: bool,
               residual: torch.Tensor | None = None) -> float:
    """Kernel B against its plain version on f32 x and on x in bf16, with
    the skip fused where ``residual`` is given.  Returns the bf16 max
    |err|."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )

    shape = tuple(x.shape)
    what = f"{shape} relu={relu} skip={residual is not None}"
    # f32: same formula, sums in another order: abs 1e-5
    err = float((instance_norm_cuda(x, relu=relu, residual=residual)
                 - instance_norm_plain(x, relu=relu, residual=residual)).abs().max())
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


def check_norm_bwd(x: torch.Tensor, dy: torch.Tensor, relu: bool) -> float:
    """Kernel B4 against its plain version on f32 and bf16.  Both sides
    take the kernel's forward statistics, which ``check_norm`` holds against
    the plain forward.  f32: the same f32 formula with sums in another
    order: abs 1e-5.  bf16: both compute in f32 from the same bf16 inputs
    and round dx once, so where an f32 sum in another order straddles a
    rounding boundary the two differ by one bf16 step: |err| <= 2^-7 |dx|
    (+ 1e-5 for the f32 difference).  The mask that B4 takes from x must be
    the forward kernel's ``out > 0`` bit for bit.  Returns the bf16 max
    |err|."""
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
        if dtype == torch.float32:
            ok, bound = float(err.max()) <= 1e-5, "abs 1e-5"
        else:
            ok = bool((err <= 2 ** -7 * ref.abs() + 1e-5).all())
            bound = "2^-7 |dx| + 1e-5"
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
    phase_convt_bwd(g)
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
                                         satclip_step=satclip_bwd)
    RESULTS["instance_norm_bwd"]["shapes"] = bwd_all
    shares = [e["bound_ms"] / e["ms"] for e in fwd_all + bwd_all]
    if max(shares) > 1.0:
        raise AssertionError(f"a kernel under its bound: {fwd_all + bwd_all}")


def phase_convt_bwd(g: torch.Generator) -> None:
    """B5 against its plain version at the train step's u1 and u0 (the
    wgmma kernels in bf16), at both train configs' batch sizes (the batch
    sets dx's tile count and dW's split-K slabs), and at a small shape that
    the wgmma kernels do not take (the WMMA kernels)."""
    from nirgan_tpu_torch.ops.convt_bwd import (
        convt_k3s2_bwd_cuda,
        convt_k3s2_bwd_plain,
    )

    dev = torch.device("cuda")
    nb, n8, s = TRAIN_BATCH, SATCLIP_BATCH, TRAIN_SIDE
    # u1: z (16,138,138,128), ct (16,276,276,64); u0: z (16,69,69,256), ct
    # (16,138,138,128); errors relative to the largest entry.  f32 (TF32
    # off): sums of 9 Co terms (dx) and of B H W terms (dW) in other
    # orders: dx 1e-5, dW 1e-4.  bf16: both round dx to bf16 after f32
    # sums, and the plain dW comes back in bf16: 1e-2 each
    worst = 0.0
    timed = {}
    for name, n, hi, ci, co in (("u1", nb, s // 2, 128, 64),
                                ("u0", nb, s // 4, 256, 128),
                                ("satclip_u1", n8, s // 2, 128, 64),
                                ("satclip_u0", n8, s // 4, 256, 128),
                                ("small", 2, 20, 64, 32)):
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
            log("kernels", f"convt_bwd {name} {dtype}: dx max|err| {ex:.3e} "
                f"relative {relx:.3e} (bound {bx:.0e}); dW max|err| {ew:.3e} "
                f"relative {relw:.3e} (bound {bw:.0e})")
            if not (relx <= bx and relw <= bw and gw.dtype == torch.float32):
                raise AssertionError(f"convt_bwd {name} {dtype}: {relx}, {relw}")
            if dtype == torch.bfloat16:
                worst = max(worst, ex)
        if name == "small":
            continue
        zb, cb = z.bfloat16(), ct.bfloat16()
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
        log("kernels", f"convt_bwd {name} bf16 dx+dW: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"aten.convolution_backward {lib_ms:.4f} ms, bound {least[0]:.4f} ms "
            f"({least[1]}); paced by the host {paced_ms:.4f} ms a call")
        timed[name] = (f"{name}: z {tuple(z.shape)}, ct {tuple(ct.shape)}", ms,
                       plain_ms, lib_ms, least)
    RESULTS["convt_bwd"] = entry(
        "convt_bwd", "convt_bwd.cu", "nirgan_tpu/ops/pallas_convt_bwd.py:170",
        worst, timed.pop("u1"), **timed)


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


def write_tiles(root: str, n: int = 8) -> tuple[np.ndarray, np.ndarray]:
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


def phase_serving(tmp: str, config: str = CONFIG, tag: str = "serving") -> dict:
    """The serving CLI on ``config`` (``tag`` names the run's lines and
    output folders).  Returns the run's launches."""
    from nirgan_tpu_torch import create_synthetic_dataset as cli
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference import serve_batch
    from nirgan_tpu_torch.tasks import Px2PxTask

    data = os.path.join(tmp, "data")
    hr_np, lr_np, coords = write_tiles(data)

    def argv(out: str) -> list:
        return ["--config", config, "--data", data, "--out",
                os.path.join(tmp, f"{tag}_{out}"), "--ckpt",
                os.path.join(tmp, "no.ckpt"), "--device", "cuda",
                "--batch-size", str(BATCH)]

    reset_counts()
    n = cli.main(argv("synth"))
    torch.cuda.synchronize()
    launches = counts()
    log(tag, f"CLI on {os.path.basename(config)} wrote {n} tiles; launches in "
        f"the run {launches}")
    if min(launches[k] for k in SERVING_KERNELS) == 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    out = os.path.join(tmp, f"{tag}_synth")
    files = sorted(os.listdir(out))
    if n != 8 or len(files) != 8:
        raise AssertionError(f"expected 8 tiles, got {n} / {files}")
    tiles = [np.load(os.path.join(out, f))["nir"] for f in files]
    for f, t in zip(files, tiles):
        if t.dtype != np.float16 or t.shape != (1, TILE, TILE) or not np.isfinite(t).all():
            raise AssertionError(f"{f}: {t.dtype} {t.shape} finite={np.isfinite(t).all()}")

    # the first batch through the plain path: histogram matching maps both
    # onto the S2 reference's values, so near-tied pixels may swap; PSNR
    # over the reference's range >= 35 dB
    task = Px2PxTask(load_config(config), device="cuda", seed=SEED)
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
    worst = max(abs(got[k] - ref[k]) / (atol + rtol * abs(ref[k])) for k in ref)
    log("train", f"{what}: worst |err| / bound {worst:.3f} (bound: rtol {rtol:.0e}"
        f" + atol {atol:.0e}); " + ", ".join(
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


def phase_train(tmp: str, satclip: bool = False) -> tuple[dict, dict]:
    """The training path of ``config_px2px.yaml`` or (``satclip``) of the
    flagship ``config_px2px_SatCLIP.yaml``, whose CLI run takes the CLI's
    default arguments.  Returns the launches of the training CLI's run and
    of one step."""
    from nirgan_tpu_torch.config import load_config
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
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    state, plain_state = task.init_state(), plain.init_state()
    ex = task.extract_batch(batch)
    if satclip and tuple(ex["embeds"].shape) != (n_batch, 256):
        raise AssertionError(f"embeds {tuple(ex['embeds'].shape)}")
    reset_counts()
    metrics = task.train_step(state, ex)
    got = loss_terms(metrics)
    torch.cuda.synchronize()
    per_step = counts()
    log("train", f"{name}: launches per step {per_step} (want {STEP_LAUNCHES})")
    if per_step != STEP_LAUNCHES:
        raise AssertionError(f"launches {per_step} != {STEP_LAUNCHES}")
    check_gradients(task)
    if satclip:
        # the learnable scale moved off its init by Adam's first step
        scale = float(metrics["scale_param"])
        log("train", f"scale_param after the step: {scale:.6f} (init "
            f"{float(cfg.satclip.scaling_param_init)})")
        if not (math.isfinite(scale) and scale != float(cfg.satclip.scaling_param_init)):
            raise AssertionError(f"scale_param did not move: {scale}")
    # the same seeded step again: every sum on the path runs in a fixed
    # order, so terms and gradients repeat bit for bit
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
    with plain_route():
        ref = loss_terms(plain.train_step(plain_state, ex))
    # bf16 activations on both routes, rounded at other points; the serving
    # forward measured 47 dB between them; the terms are means over
    # thousands of logits or pixels: within 2% + 1e-3
    check_terms(f"{name}: bf16 step 1, kernels vs plain route", got, ref, 2e-2, 1e-3)

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
    del task, plain, state, plain_state, ex
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
    batch = first_batch(small)
    on_card, on_cpu = (Px2PxTask(small, device=d, seed=SEED) for d in ("cuda", "cpu"))
    reset_counts()
    got = loss_terms(on_card.train_step(on_card.init_state(),
                                        on_card.extract_batch(batch)))
    launched = counts()
    ref = loss_terms(on_cpu.train_step(on_cpu.init_state(),
                                       on_cpu.extract_batch(batch)))
    # f32 on both sides, sums in other orders: rtol 1e-4
    check_terms(f"{name}: f32 step 1, card vs CPU (launches {launched})", got, ref,
                1e-4, 1e-6)
    if min(launched.values()) == 0:
        raise AssertionError(f"the f32 step skipped a kernel: {launched}")
    del on_card, on_cpu

    # --- the training CLI: 8 steps, then a resume for 2 more.  The plain
    # config has 4 steps an epoch (validations at 4 and 8, one batch each);
    # the SatCLIP config, run by the CLI's default arguments, 8 steps an
    # epoch (one validation at 8, one batch)
    run = os.path.join(tmp, "run_satclip" if satclip else "run")
    argv = ["--log-every", "1"] if satclip else ["--config", CONFIG, "--device",
                                                 "cuda", "--log-every", "1"]
    val_steps, n_eval = ([8], 1) if satclip else ([4, 8], 2)
    reset_counts()
    t0 = time.perf_counter()
    final = cli.main(argv + ["--logdir", run, "--max-steps", "8"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    want = {k: 8 * STEP_LAUNCHES[k] + n_eval * EVAL_LAUNCHES[k] for k in STEP_LAUNCHES}
    log("train", f"CLI {' '.join(argv)}: {final.step} steps in {dt:.2f} s (set-up "
        f"included); launches {launches} (want {want})")
    if final.step != 8 or launches != want:
        raise AssertionError(f"CLI run: step {final.step}, launches {launches}")
    missing = [f for f in ("last.pt", "best.pt", "sched_state_last.json",
                           "sched_state_best.json", "config.yaml")
               if not os.path.isfile(os.path.join(run, f))]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "model_loss/generator_total_loss" in r]
    val = [r for r in rows if "val/L1" in r]
    keys = list(got) + (["scale_param"] if satclip else [])
    finite = all(math.isfinite(r[k]) for r in train for k in keys)
    log("train", f"CLI: train rows at steps {[r['step'] for r in train]}, val "
        f"rows at {[r['step'] for r in val]}; generator_total_loss "
        f"{train[0]['model_loss/generator_total_loss']:.4f} -> "
        f"{train[-1]['model_loss/generator_total_loss']:.4f}; val/L1 "
        f"{[round(r['val/L1'], 5) for r in val]}; images/s (host clock, steps "
        f"2-8) {[round(r['perf/images_per_sec'], 1) for r in train[1:]]}"
        + (f"; scale_param {[round(r['scale_param'], 5) for r in train]}"
           if satclip else ""))
    if (missing or not finite or [r["step"] for r in val] != val_steps
            or len(train) != 8):
        raise AssertionError(f"CLI run: missing {missing}, finite {finite}, "
                             f"val steps {[r['step'] for r in val]}")
    resumed = cli.main(argv + ["--resume", run, "--max-steps", "10"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        val = [json.loads(line)["step"] for line in f if "val/L1" in line]
    log("train", f"CLI resume: {resumed.step} steps, val rows at {val}")
    if resumed.step != 10 or val != val_steps + [10]:
        raise AssertionError(f"resume: step {resumed.step}, val rows {val}")
    return launches, per_step


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


# kernel-name fragments -> the rows of the profile's breakdown, first match
PROFILE_GROUPS = (
    ("igemm_wgmma_kernel<256>", "wgmma implicit GEMM, N = 256 (kernel A; B5 dx at u0)"),
    ("igemm_wgmma_kernel<128>", "wgmma implicit GEMM, N = 128 (B5 dx at u1)"),
    ("trunk_conv_", "kernel A, WMMA / SIMT"),
    ("convt_dw_", "B5 dW and its reduce"),
    ("convt_dx_", "B5 dx, WMMA / SIMT"),
    ("in_resident_kernel", "resident, one launch a call"),
    ("in_partial_kernel", "streaming sums"),
    ("in_apply_kernel", "streaming elementwise"),
    ("head_conv_mma_kernel", "C head, mma.sync"),
    ("head_conv_kernel", "C head, f32 FMA"),
    ("reflection_pad", "reflect pad"),
    ("multi_tensor_apply", "Adam"),
    ("cudnn", "cuDNN convs"), ("xmma", "cuDNN convs"), ("cutlass", "cuDNN convs"),
    ("convolve", "cuDNN convs"), ("wgrad", "cuDNN convs"), ("dgrad", "cuDNN convs"),
    ("nchwToNhwc", "cuDNN layout"), ("nhwcToNchw", "cuDNN layout"),
    ("copy", "copies (layout, casts)"),
    ("reduce_kernel", "PyTorch reductions"),
    ("elementwise", "PyTorch elementwise"),
)


def profile_window(what: str, fn, iters: int) -> None:
    """``iters`` calls of ``fn`` under ``torch.profiler`` after a warm-up;
    prints the device time per call of each group of kernels."""
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


def phase_profile() -> None:
    """Where the time goes (``python3 chip_smoke.py --profile``): the
    serving forward and the fused train step of the full-width configs under
    ``torch.profiler``, the plain route (``config_px2px.yaml``) and the
    SatCLIP inject route (``config_px2px_SatCLIP.yaml``), on the kernels and
    on the plain versions; and the head's backward, which is PyTorch's
    convolution gradients, timed on its own."""
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G, define_G_inject
    from nirgan_tpu_torch.ops.head_conv import head_conv_bwd, head_conv_cuda
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

    step, step_inject = stepper(CONFIG), stepper(SATCLIP_CONFIG)
    runs = (("serving forward", forward, 10), ("train step, batch 16", step, 5),
            ("serving forward, inject", forward_inject, 10),
            ("train step, inject, batch 8", step_inject, 5))
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
    for n in (TRAIN_BATCH, SATCLIP_BATCH):
        xh = torch.randn((n, TRAIN_SIDE + 6, TRAIN_SIDE + 6, 64), device=dev,
                         generator=g).bfloat16()
        y = head_conv_cuda(xh, w, b)
        ct = torch.randn(y.shape, device=dev, generator=g).bfloat16()
        ms = time_ms(lambda: head_conv_bwd(xh, w, y, ct), iters=10, run_ahead=True)
        fwd = time_ms(lambda: head_conv_cuda(xh, w, b), iters=10, run_ahead=True)
        log("profile", f"head backward (tanh', cuDNN dgrad + wgrad, bias sum) on "
            f"{tuple(xh.shape)}: {ms:.4f} ms; its forward, kernel C: {fwd:.4f} ms")
        del xh, y, ct
    for what, fn, iters in runs:
        profile_window(f"{what}, kernels", fn, 5)
        profile_window(f"{what}, plain route", plain(fn), 5)


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


def device_launches(fn) -> int:
    """The kernels and device copies that one call of ``fn`` runs on the
    card, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation and ev.device_time_total)


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
                    counted[key] = device_launches(
                        lambda: instance_norm_bwd_cuda(xb, gb, stats, e["relu"]))
                else:
                    counted[key] = device_launches(lambda: instance_norm_cuda(
                        xb, relu=e["relu"], residual=rb if e["skip"] else None))
                log("launches", f"{name} {e['shape']} relu={e['relu']} "
                    f"skip={e.get('skip', False)}: {counted[key]} on the card a "
                    f"call ({e['regime']})")
            e["cuda_launches"] = counted[key]
            if counted[key] != (1 if e["regime"] == "resident" else 2):
                raise AssertionError(f"{name} {e['shape']}: {counted[key]} launches "
                                     f"a call in the {e['regime']} regime")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    import nirgan_tpu_torch  # noqa: F401  (fail before printing anything)

    os.chdir(ROOT)  # the training CLI's default configs are relative paths

    device = phase_device()
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        phase_profile()
        return
    if sys.argv[1:] == ["--sweep"]:
        phase_sweep()
        return
    phase_kernels()
    per_forward = phase_generator()
    sat_forward = phase_generator(satclip=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving = phase_serving(tmp)
        sat_serving = phase_serving(tmp, SATCLIP_CONFIG, "serving, inject")
        launches, per_step = phase_train(tmp)
        sat_launches, sat_step = phase_train(tmp, satclip=True)
    phase_concat()
    phase_norm_launches()
    if min(launches.values()) == 0 or min(sat_launches.values()) == 0:
        raise AssertionError(f"a kernel of the training path was not launched: "
                             f"{launches}, {sat_launches}")
    entries = []
    for name in STEP_LAUNCHES:
        kernel = {**RESULTS[name], "launches": launches[name],
                  "per_step": per_step[name],
                  "satclip": {"launches": sat_launches[name],
                              "per_step": sat_step[name]}}
        if name in SERVING_KERNELS:
            kernel["serving"]["launches"] = serving[name]
            kernel["serving"]["per_forward"] = per_forward[name]
            kernel["satclip"]["serving_launches"] = sat_serving[name]
            kernel["satclip"]["per_forward"] = sat_forward[name]
        entries.append(kernel)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
