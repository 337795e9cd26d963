"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits non-zero and
never prints the final ``"ok": true`` line:

0. device: a CUDA card is required; prints ``nvidia-smi`` name and power
   limit.
1. build: compiles the hand-written kernels (``nirgan_tpu_torch/csrc``).
2. kernels: each kernel against its plain PyTorch version, f32 and bf16,
   with the time of both: the forward kernels at the serving path's shapes
   (batch 4 of 512^2 tiles padded to 532^2), and every kernel at the train
   step's (batch 16 of 256^2 tiles padded to 276^2; the instance norm at
   all six, C = 512 included).
3. generator: the full-width ``resnet_9blocks`` (ngf 64), random weights
   from a seed, batch 4 at 532^2 in bf16: kernel path against the plain
   path, launches per forward, forward time; then ``predict_step`` in f32
   on the card against the same task on the CPU.
4. serving: ``python -m nirgan_tpu_torch.create_synthetic_dataset`` on 8
   seeded uint16 tiles (HR 512^2 3-band, LR 128^2 4-band) with
   ``--device cuda --batch-size 4``; launch counts of that run, output
   checks, agreement with the plain path, and tiles/s of a warm rerun of
   the CLI.
5. train: one fused GAN step of the full-width config (batch 16 at 256^2,
   bf16) on the kernels against the plain route, launches per step, a
   finite non-zero gradient for every parameter, the same gradients bit
   for bit from a second run of the seeded step, step times; an f32 step
   on the card against the same seeded step on the CPU at a small config;
   then ``python -m nirgan_tpu_torch.train`` for 8 steps on the fake data
   (two validations, ``last`` and ``best``) and a resume for 2 more.

Before the last line it prints one JSON object with every kernel's route,
source, launches in the training CLI's run, error, and times at the train
step's ``shape``; a forward kernel's ``serving`` entry holds the serving
path's shape, times and launches.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "config_px2px.yaml")
BATCH = 4
TILE, LR_TILE, PAD = 512, 128, 10
SIDE = TILE + 2 * PAD  # 532: the generator's input side at serving
TRAIN_BATCH, TRAIN_TILE = 16, 256
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


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare_ms(kernel_fn, plain_fn, iters: int = 20) -> tuple[float, float]:
    """Kernel and plain times taken in turns (kernel, plain, plain, kernel)
    and averaged, so drift on the card weighs on both alike."""
    k1, p1 = time_ms(kernel_fn, iters), time_ms(plain_fn, iters)
    p2, k2 = time_ms(plain_fn, iters), time_ms(kernel_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def entry(name: str, source: str, replaces: str, err: float, train: tuple,
          serving: tuple | None = None) -> dict:
    """A kernel's JSON entry.  ``train`` and ``serving`` are (shape, ms,
    plain_ms).  ``ms`` and ``plain_ms`` are at the train step's shape,
    since ``launches`` are the training CLI's; the serving path's shape and
    times sit under ``serving``, beside that run's launches."""
    shape, ms, plain_ms = train
    out = dict(name=name, route="cuda", source=f"nirgan_tpu_torch/csrc/{source}",
               replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               shape=str(shape))
    if serving is not None:
        shape, ms, plain_ms = serving
        out["serving"] = dict(shape=str(shape), ms=ms, plain_ms=plain_ms)
    return out


def check_trunk(g: torch.Generator, shape: tuple) -> tuple[float, float, float]:
    """Kernel A against its plain version on x of ``shape`` (B, H, W, 256),
    f32 and bf16, both pad modes.  Returns the worst bf16 max |err| and the
    bf16 kernel and plain ms."""
    from nirgan_tpu_torch.ops.pad import reflect_pad2d
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda, trunk_conv_plain

    dev = torch.device("cuda")
    x = torch.randn(shape, device=dev, generator=g)
    w = torch.randn((256, 256, 3, 3), device=dev, generator=g) / 48.0
    b = torch.randn((256,), device=dev, generator=g) * 0.1
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
            log("kernels", f"trunk_conv {dtype} {shape} pad={pad}: max|err| "
                f"{err:.3e}, relative {rel:.3e} (bound {bound:.0e})")
            if not rel <= bound:
                raise AssertionError(f"trunk_conv {dtype} {shape} pad={pad}: "
                                     f"{rel} > {bound}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    xb = x.bfloat16()
    ms, plain_ms = compare_ms(lambda: trunk_conv_cuda(xb, w, b),
                              lambda: trunk_conv_plain(xb, w, b))
    n, h, wd, c = shape
    tflops = 2 * n * h * wd * 9 * c * c / (ms * 1e-3) / 1e12
    log("kernels", f"trunk_conv bf16 {shape}: kernel {ms:.4f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def check_head(g: torch.Generator, shape: tuple) -> tuple[float, float, float]:
    """Kernel C against its plain version on x of ``shape`` (B, H, W, 64),
    f32 and bf16.  Returns the bf16 max |err| and the bf16 kernel and plain
    ms."""
    from nirgan_tpu_torch.ops.head_conv import head_conv_cuda, head_conv_plain

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
    xb = x.bfloat16()
    ms, plain_ms = compare_ms(lambda: head_conv_cuda(xb, w, b),
                              lambda: head_conv_plain(xb, w, b))
    log("kernels", f"head_conv bf16 {shape}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_norm(x: torch.Tensor, relu: bool) -> float:
    """Kernel B against its plain version on f32 x and on x in bf16.
    Returns the bf16 max |err|."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )

    shape = tuple(x.shape)
    # f32: same formula, sums in another order: abs 1e-5
    err = float((instance_norm_cuda(x, relu=relu)
                 - instance_norm_plain(x, relu=relu)).abs().max())
    log("kernels", f"instance_norm f32 {shape} relu={relu}: "
        f"max|err| {err:.3e} (bound 1e-05)")
    if not err <= 1e-5:
        raise AssertionError(f"instance_norm f32 {shape} relu={relu}: {err}")
    # bf16: both sides round mean, scale, x - mean and the product to bf16;
    # an f32 statistic summed in another order can round to the
    # neighbouring bf16 value, which moves x - mean and y by a step each:
    # |err| <= 2^-6 * (|y| + 1), four bf16 steps of y
    xb = x.bfloat16()
    ref = instance_norm_plain(xb, relu=relu).float()
    got = instance_norm_cuda(xb, relu=relu).float()
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / (ref.abs() + 1)).max())
    log("kernels", f"instance_norm bf16 {shape} relu={relu}: max|err| "
        f"{err:.3e}, max|err|/(|y|+1) {rel:.3e} (bound {2 ** -6:.3e})")
    if not rel <= 2 ** -6:
        raise AssertionError(f"instance_norm bf16 {shape} relu={relu}: {rel}")
    return err


def norm_times(xb: torch.Tensor, relu: bool) -> tuple[float, float]:
    """bf16 kernel B and plain ms on xb."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )

    per = compare_ms(lambda: instance_norm_cuda(xb, relu=relu),
                     lambda: instance_norm_plain(xb, relu=relu), iters=10)
    gbs = 3 * xb.numel() * 2 / (per[0] * 1e-3) / 1e9
    log("kernels", f"instance_norm bf16 {tuple(xb.shape)} relu={relu}: kernel "
        f"{per[0]:.4f} ms ({gbs:.0f} GB/s at 3 passes), plain {per[1]:.4f} ms")
    return per


def phase_kernels() -> None:
    """Every kernel against its plain version: the forward kernels at the
    serving forward's shapes and at the train step's, the backward kernels
    at the train step's."""
    # f32 references must not round through TF32 in cuDNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)

    # --- A at the trunk's shape in serving and in training
    serving = (BATCH, SIDE // 4, SIDE // 4, 256)
    train = (TRAIN_BATCH, TRAIN_SIDE // 4, TRAIN_SIDE // 4, 256)
    e1, *s_times = check_trunk(g, serving)
    e2, *t_times = check_trunk(g, train)
    RESULTS["trunk_conv"] = entry(
        "trunk_conv", "trunk_conv.cu", "nirgan_tpu/ops/pallas_trunk.py:240",
        max(e1, e2), (train, *t_times), (serving, *s_times))

    # --- C at the head's input in serving and in training (reflect-padded
    # by 3 around the generator's input side)
    serving = (BATCH, SIDE + 6, SIDE + 6, 64)
    train = (TRAIN_BATCH, TRAIN_SIDE + 6, TRAIN_SIDE + 6, 64)
    e1, *s_times = check_head(g, serving)
    e2, *t_times = check_head(g, train)
    RESULTS["head_conv"] = entry(
        "head_conv", "head_conv.cu", "nirgan_tpu/ops/pallas_head.py:135",
        max(e1, e2), (train, *t_times), (serving, *s_times))
    phase_norms(g)
    phase_convt_bwd(g)
    torch.cuda.synchronize()


def phase_norms(g: torch.Generator) -> None:
    """Kernel B at the serving forward's three IN shapes; B and B4 at the
    train step's six (G at 276^2, 138^2, 69^2; D at 64^2, 32^2, 31^2, where
    C = 512 is the PatchGAN's norm3), ReLU fused and not."""
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_bwd_cuda,
        instance_norm_bwd_plain,
        instance_norm_cuda,
    )

    dev = torch.device("cuda")
    worst = 0.0
    s = SIDE
    for shape in ((BATCH, s, s, 64), (BATCH, s // 2, s // 2, 128),
                  (BATCH, s // 4, s // 4, 256)):
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        for relu in (False, True):
            worst = max(worst, check_norm(x, relu))
        # the last is the shape of 19 of the 23 calls a serving forward makes
        serving = (shape, *norm_times(x.bfloat16(), True))

    # B4: both sides take the kernel's forward statistics and output, which
    # check_norm has just held against the plain forward.  f32: the same
    # f32 formula with sums in another order: abs 1e-5.  bf16: both compute
    # in f32 from the same bf16 inputs and round dx once, so where an f32
    # sum in another order straddles a rounding boundary the two differ by
    # one bf16 step: |err| <= 2^-7 |dx| (+ 1e-5 for the f32 difference)
    n, s = TRAIN_BATCH, TRAIN_SIDE
    shapes = [(n, s, s, 64), (n, s // 2, s // 2, 128), (n, s // 4, s // 4, 256),
              (n, 64, 64, 128), (n, 32, 32, 256), (n, 31, 31, 512)]
    worst_bwd = 0.0
    for i, shape in enumerate(shapes):
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        dy = torch.randn(shape, device=dev, generator=g)
        for relu in (False, True):
            worst = max(worst, check_norm(x, relu))
            for dtype in (torch.float32, torch.bfloat16):
                xd, gd = x.to(dtype), dy.to(dtype)
                y, stats = instance_norm_cuda(xd, relu=relu, return_stats=True)
                out = y if relu else None
                ref = instance_norm_bwd_plain(xd, gd, stats, out).float()
                got = instance_norm_bwd_cuda(xd, gd, stats, out).float()
                err = (got - ref).abs()
                if dtype == torch.float32:
                    ok, bound = float(err.max()) <= 1e-5, "abs 1e-5"
                else:
                    ok = bool((err <= 2 ** -7 * ref.abs() + 1e-5).all())
                    bound = "2^-7 |dx| + 1e-5"
                    worst_bwd = max(worst_bwd, float(err.max()))
                log("kernels", f"instance_norm_bwd {dtype} {shape} relu={relu}: "
                    f"max|err| {float(err.max()):.3e} (bound {bound})")
                if not ok:
                    raise AssertionError(f"instance_norm_bwd {dtype} {shape} "
                                         f"relu={relu}: {float(err.max())}")
        # time each shape with the ReLU flag the step uses there
        relu = i < 3
        xb, gb = x.bfloat16(), dy.bfloat16()
        fwd = norm_times(xb, relu)
        y, stats = instance_norm_cuda(xb, relu=relu, return_stats=True)
        out = y if relu else None
        bwd = compare_ms(lambda: instance_norm_bwd_cuda(xb, gb, stats, out),
                         lambda: instance_norm_bwd_plain(xb, gb, stats, out),
                         iters=10)
        gbs = (5 + relu) * xb.numel() * 2 / (bwd[0] * 1e-3) / 1e9
        log("kernels", f"instance_norm_bwd bf16 {shape} relu={relu}: kernel "
            f"{bwd[0]:.4f} ms ({gbs:.0f} GB/s at {5 + relu} passes), plain "
            f"{bwd[1]:.4f} ms")
        if i == 2:  # the shape of 19 of the 32 calls a step makes
            train_fwd, train_bwd = (shape, *fwd), (shape, *bwd)
    source, replaces = "instance_norm.cu", "nirgan_tpu/ops/pallas_kernels.py:130"
    RESULTS["instance_norm"] = entry("instance_norm", source, replaces, worst,
                                     train_fwd, serving)
    RESULTS["instance_norm_bwd"] = entry("instance_norm_bwd", source, replaces,
                                         worst_bwd, train_bwd)


def phase_convt_bwd(g: torch.Generator) -> None:
    """B5 against its plain version at the train step's u1 and u0."""
    from nirgan_tpu_torch.ops.convt_bwd import (
        convt_k3s2_bwd_cuda,
        convt_k3s2_bwd_plain,
    )

    dev = torch.device("cuda")
    n, s = TRAIN_BATCH, TRAIN_SIDE
    # u1: z (16,138,138,128), ct (16,276,276,64); u0: z (16,69,69,256), ct
    # (16,138,138,128); errors relative to the largest entry.  f32 (TF32
    # off): sums of 9 Co terms (dx) and of B H W terms (dW) in other
    # orders: dx 1e-5, dW 1e-4.  bf16: both round dx to bf16 after f32
    # sums, and the plain dW comes back in bf16: 1e-2 each
    worst = 0.0
    for name, hi, ci, co in (("u1", s // 2, 128, 64), ("u0", s // 4, 256, 128)):
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
        zb, cb = z.bfloat16(), ct.bfloat16()
        ms, plain_ms = compare_ms(lambda: convt_k3s2_bwd_cuda(cb, zb, w),
                                  lambda: convt_k3s2_bwd_plain(cb, zb, w),
                                  iters=10)
        tflops = 2 * 2 * n * hi * hi * 9 * ci * co / (ms * 1e-3) / 1e12
        log("kernels", f"convt_bwd {name} bf16 dx+dW: kernel {ms:.4f} ms "
            f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        if name == "u1":
            u1 = (f"u1: z {tuple(z.shape)}, ct {tuple(ct.shape)}", ms, plain_ms)
    RESULTS["convt_bwd"] = entry(
        "convt_bwd", "convt_bwd.cu", "nirgan_tpu/ops/pallas_convt_bwd.py:170",
        worst, u1)


def phase_generator() -> None:
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.models import define_G
    from nirgan_tpu_torch.tasks import Px2PxTask

    dev = torch.device("cuda")
    G = define_G(3, 1, 64, "resnet_9blocks", "instance",
                 compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    x = torch.rand((BATCH, SIDE, SIDE, 3), generator=torch.Generator().manual_seed(1))
    x = (x * 0.3).to(dev)
    with torch.inference_mode():
        reset_counts()
        y = G(x)
        torch.cuda.synchronize()
        per_forward = counts()
        with plain_route():
            y_plain = G(x)
        torch.cuda.synchronize()
        want = EVAL_LAUNCHES
        log("generator", f"launches per forward {per_forward} (want {want})")
        if per_forward != want:
            raise AssertionError(f"launches {per_forward} != {want}")
        if tuple(y.shape) != (BATCH, SIDE, SIDE, 1) or not torch.isfinite(y).all():
            raise AssertionError(f"bad generator output {tuple(y.shape)}")
        # tanh outputs span 2; the JAX package measured its own bf16-vs-f32
        # floor at 43 dB, so kernels vs plain in bf16 must reach 40 dB
        db = psnr(y, y_plain, 2.0)
        log("generator", f"bf16 kernel path vs plain path: PSNR {db:.2f} dB "
            f"(bound 40), max|err| {float((y.float() - y_plain.float()).abs().max()):.3e}")
        if not db >= 40.0:
            raise AssertionError(f"generator PSNR {db} < 40")

        def plain_forward():
            with plain_route():
                return G(x)

        ms, plain_ms = compare_ms(lambda: G(x), plain_forward, iters=10)
        log("generator", f"bf16 forward of {BATCH} x {SIDE}^2: kernels {ms:.3f} ms "
            f"({BATCH / ms * 1e3:.2f} tiles/s), plain {plain_ms:.3f} ms "
            f"({BATCH / plain_ms * 1e3:.2f} tiles/s)")

    # predict_step in f32 on the card (kernels, TF32 off) against the same
    # seeded task on the CPU (plain versions)
    cfg = load_config(CONFIG)
    cfg.tpu.compute_dtype = "float32"
    rgb = np.random.default_rng(2).random((2, 3, 64, 64), dtype=np.float32) * 0.3
    reset_counts()
    got = Px2PxTask(cfg, device="cuda", seed=SEED).predict_step(rgb)
    on_card = counts()
    ref = Px2PxTask(cfg, device="cpu", seed=SEED).predict_step(rgb)
    err = float(np.abs(got - ref).max())
    # f32 on both sides; nine IN-normalised blocks amplify summation-order
    # differences, so abs 1e-3 on tanh outputs
    log("generator", f"predict_step f32 (2, 3, 64, 64), card vs CPU: "
        f"max|err| {err:.3e} (bound 1e-03), launches {on_card}")
    if not (got.shape == (2, 1, 64, 64) and err <= 1e-3):
        raise AssertionError(f"predict_step card vs CPU: {got.shape}, {err}")
    if min(on_card[k] for k in SERVING_KERNELS) == 0:
        raise AssertionError(f"predict_step on the card skipped a kernel: {on_card}")


def write_tiles(root: str, n: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Seeded uint16 DN tiles in the LR/HR ``.npz`` layout the CLI reads;
    returns the HR and LR stacks."""
    rng = np.random.default_rng(SEED)
    hr = rng.integers(0, 3000, (n, 3, TILE, TILE), dtype=np.uint16)
    lr = rng.integers(0, 3000, (n, 4, LR_TILE, LR_TILE), dtype=np.uint16)
    for sub in ("HR", "LR"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        np.savez(os.path.join(root, "HR", f"tile_{i:03d}.npz"), img=hr[i])
        np.savez(os.path.join(root, "LR", f"tile_{i:03d}.npz"), img=lr[i])
    return hr, lr


def phase_serving(tmp: str) -> dict:
    from nirgan_tpu_torch import create_synthetic_dataset as cli
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.inference import serve_batch
    from nirgan_tpu_torch.tasks import Px2PxTask

    data = os.path.join(tmp, "data")
    hr_np, lr_np = write_tiles(data)

    def argv(out: str) -> list:
        return ["--config", CONFIG, "--data", data, "--out", os.path.join(tmp, out),
                "--ckpt", os.path.join(tmp, "no.ckpt"), "--device", "cuda",
                "--batch-size", str(BATCH)]

    reset_counts()
    n = cli.main(argv("synth"))
    torch.cuda.synchronize()
    launches = counts()
    log("serving", f"CLI wrote {n} tiles; launches in the run {launches}")
    if min(launches[k] for k in SERVING_KERNELS) == 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    out = os.path.join(tmp, "synth")
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
    task = Px2PxTask(load_config(CONFIG), device="cuda", seed=SEED)
    hr = torch.from_numpy(hr_np[:BATCH]).cuda().permute(0, 2, 3, 1)
    s2 = torch.from_numpy(lr_np[:BATCH, 3:4]).cuda().permute(0, 2, 3, 1)
    with plain_route():
        plain = serve_batch(task, hr, s2).float().cpu().numpy().transpose(0, 3, 1, 2)
    got = np.stack(tiles[:BATCH]).astype(np.float32)
    span = float(plain.max() - plain.min())
    mse = float(np.mean((got - plain) ** 2))
    db = math.inf if mse == 0 else 10 * math.log10(span ** 2 / mse)
    log("serving", f"CLI tiles vs plain path: PSNR {db:.2f} dB over range "
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
    log("serving", f"warm CLI rerun: {m} tiles in {dt:.3f} s = {m / dt:.2f} "
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
    return {k: np.stack([it[k] for it in items]) for k in ("rgb", "nir")}


def phase_train(tmp: str) -> dict:
    from nirgan_tpu_torch.config import load_config
    from nirgan_tpu_torch.tasks import Px2PxTask
    from nirgan_tpu_torch.train import cli

    # --- one fused step of the full-width config, kernels vs plain route
    cfg = load_config(CONFIG)
    batch = first_batch(cfg)
    if batch["rgb"].shape != (TRAIN_BATCH, 3, TRAIN_TILE, TRAIN_TILE):
        raise AssertionError(f"train batch {batch['rgb'].shape}")
    task = Px2PxTask(cfg, device="cuda", seed=SEED)
    plain = Px2PxTask(cfg, device="cuda", seed=SEED)
    state, plain_state = task.init_state(), plain.init_state()
    ex = task.extract_batch(batch)
    reset_counts()
    got = loss_terms(task.train_step(state, ex))
    torch.cuda.synchronize()
    per_step = counts()
    log("train", f"launches per step {per_step} (want {STEP_LAUNCHES})")
    if per_step != STEP_LAUNCHES:
        raise AssertionError(f"launches {per_step} != {STEP_LAUNCHES}")
    for tag, net in (("G", task.netG), ("D", task.netD)):
        bad = [k for k, p in net.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or float(p.grad.abs().max()) == 0.0]
        n = sum(1 for _ in net.parameters())
        log("train", f"{tag}: {n - len(bad)} of {n} parameters have a finite, "
            "non-zero gradient on the kernel path")
        if bad:
            raise AssertionError(f"{tag} parameters without a gradient: {bad}")
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
    check_terms("bf16 step 1, kernels vs plain route", got, ref, 2e-2, 1e-3)

    def plain_step():
        with plain_route():
            plain.train_step(plain_state, ex)

    ms, plain_ms = compare_ms(lambda: task.train_step(state, ex), plain_step,
                              iters=5)
    log("train", f"bf16 fused step, batch {TRAIN_BATCH} at {TRAIN_SIDE}^2: kernels "
        f"{ms:.3f} ms ({TRAIN_BATCH / ms * 1e3:.2f} images/s), plain "
        f"{plain_ms:.3f} ms ({TRAIN_BATCH / plain_ms * 1e3:.2f} images/s)")
    del task, plain, state, plain_state, ex
    torch.cuda.empty_cache()

    # --- an f32 step on the card (TF32 off) vs the same seeded step on the
    # CPU, 6 blocks at 64^2 (the head kernel needs ngf 64)
    small = load_config(CONFIG)
    small.tpu.compute_dtype = "float32"
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
    check_terms(f"f32 step 1, card vs CPU (launches {launched})", got, ref,
                1e-4, 1e-6)
    if min(launched.values()) == 0:
        raise AssertionError(f"the f32 step skipped a kernel: {launched}")

    # --- the training CLI: 8 steps (4 an epoch, two validations), resume
    run = os.path.join(tmp, "run")
    argv = ["--config", CONFIG, "--device", "cuda", "--log-every", "1"]
    reset_counts()
    t0 = time.perf_counter()
    final = cli.main(argv + ["--logdir", run, "--max-steps", "8"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    want = {k: 8 * STEP_LAUNCHES[k] + 2 * EVAL_LAUNCHES[k] for k in STEP_LAUNCHES}
    log("train", f"CLI: {final.step} steps in {dt:.2f} s (set-up included); "
        f"launches {launches} (want {want})")
    if final.step != 8 or launches != want:
        raise AssertionError(f"CLI run: step {final.step}, launches {launches}")
    missing = [f for f in ("last.pt", "best.pt", "sched_state_last.json",
                           "sched_state_best.json", "config.yaml")
               if not os.path.isfile(os.path.join(run, f))]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "model_loss/generator_total_loss" in r]
    val = [r for r in rows if "val/L1" in r]
    finite = all(math.isfinite(r[k]) for r in train for k in got)
    log("train", f"CLI: train rows at steps {[r['step'] for r in train]}, val "
        f"rows at {[r['step'] for r in val]}; generator_total_loss "
        f"{train[0]['model_loss/generator_total_loss']:.4f} -> "
        f"{train[-1]['model_loss/generator_total_loss']:.4f}; val/L1 "
        f"{[round(r['val/L1'], 5) for r in val]}; images/s (host clock, steps "
        f"2-8) {[round(r['perf/images_per_sec'], 1) for r in train[1:]]}")
    if (missing or not finite or [r["step"] for r in val] != [4, 8]
            or len(train) != 8):
        raise AssertionError(f"CLI run: missing {missing}, finite {finite}, "
                             f"val steps {[r['step'] for r in val]}")
    resumed = cli.main(argv + ["--resume", run, "--max-steps", "10"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        val = [json.loads(line)["step"] for line in f if "val/L1" in line]
    log("train", f"CLI resume: {resumed.step} steps, val rows at {val}")
    if resumed.step != 10 or val != [4, 8, 10]:
        raise AssertionError(f"resume: step {resumed.step}, val rows {val}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    import nirgan_tpu_torch  # noqa: F401  (fail before printing anything)

    device = phase_device()
    phase_build()
    phase_kernels()
    phase_generator()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving = phase_serving(tmp)
        launches = phase_train(tmp)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the training path was not launched: "
                             f"{launches}")
    entries = []
    for name in STEP_LAUNCHES:
        kernel = {**RESULTS[name], "launches": launches[name]}
        if name in SERVING_KERNELS:
            kernel["serving"]["launches"] = serving[name]
        entries.append(kernel)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
