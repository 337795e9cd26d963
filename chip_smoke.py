"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits non-zero and
never prints the final ``"ok": true`` line:

0. device: a CUDA card is required; prints ``nvidia-smi`` name and power
   limit.
1. build: compiles the hand-written kernels (``nirgan_tpu_torch/csrc``).
2. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes (batch 4 of 512^2 tiles padded to 532^2), f32 and bf16,
   with the time of both.
3. generator: the full-width ``resnet_9blocks`` (ngf 64), random weights
   from a seed, batch 4 at 532^2 in bf16: kernel path against the plain
   path, launches per forward, forward time; then ``predict_step`` in f32
   on the card against the same task on the CPU.
4. serving: ``python -m nirgan_tpu_torch.create_synthetic_dataset`` on 8
   seeded uint16 tiles (HR 512^2 3-band, LR 128^2 4-band) with
   ``--device cuda --batch-size 4``; launch counts of that run, output
   checks, agreement with the plain path, and tiles/s of a warm rerun of
   the CLI.

Before the last line it prints one JSON object with every kernel's route,
source, launches in the serving run, error and times; the last line is
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
SEED = 0

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
    from nirgan_tpu_torch.ops import head_conv, instance_norm, trunk_conv

    return {"trunk_conv": trunk_conv.trunk_conv_cuda,
            "instance_norm": instance_norm.instance_norm_cuda,
            "head_conv": head_conv.head_conv_cuda}


def reset_counts() -> None:
    for fn in kernels().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors to the plain versions instead of the kernels, to
    compare whole paths (the package itself has no such switch)."""
    from nirgan_tpu_torch.ops import head_conv, instance_norm, norm, trunk_conv

    with mock.patch.object(trunk_conv, "trunk_conv_cuda",
                           trunk_conv.trunk_conv_plain), \
         mock.patch.object(norm, "instance_norm_cuda",
                           instance_norm.instance_norm_plain), \
         mock.patch.object(head_conv, "head_conv_cuda",
                           head_conv.head_conv_plain):
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


def phase_kernels() -> None:
    from nirgan_tpu_torch.ops.head_conv import head_conv_cuda, head_conv_plain
    from nirgan_tpu_torch.ops.instance_norm import (
        instance_norm_cuda,
        instance_norm_plain,
    )
    from nirgan_tpu_torch.ops.pad import reflect_pad2d
    from nirgan_tpu_torch.ops.trunk_conv import trunk_conv_cuda, trunk_conv_plain

    # f32 references must not round through TF32 in cuDNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    # --- A: trunk conv at (4, 133, 133, 256)
    t = SIDE // 4
    x = torch.randn((BATCH, t, t, 256), device=dev, generator=g)
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
            log("kernels", f"trunk_conv {dtype} pad={pad}: max|err| {err:.3e}, "
                f"relative {rel:.3e} (bound {bound:.0e})")
            if not rel <= bound:
                raise AssertionError(f"trunk_conv {dtype} pad={pad}: {rel} > {bound}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    xb = x.bfloat16()
    ms, plain_ms = compare_ms(lambda: trunk_conv_cuda(xb, w, b),
                              lambda: trunk_conv_plain(xb, w, b))
    tflops = 2 * BATCH * t * t * 9 * 256 * 256 / (ms * 1e-3) / 1e12
    log("kernels", f"trunk_conv bf16 {tuple(xb.shape)}: kernel {ms:.4f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
    RESULTS["trunk_conv"] = dict(
        name="trunk_conv", route="cuda", source="nirgan_tpu_torch/csrc/trunk_conv.cu",
        replaces="nirgan_tpu/ops/pallas_trunk.py:240", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms)

    # --- B: instance norm at the three IN shapes of the serving forward
    shapes = [(BATCH, SIDE, SIDE, 64), (BATCH, SIDE // 2, SIDE // 2, 128),
              (BATCH, t, t, 256)]
    worst = 0.0
    for shape in shapes:
        x = torch.randn(shape, device=dev, generator=g) * 3.0 + 1.5
        for relu in (False, True):
            # f32: same formula, sums in another order: abs 1e-5
            ref = instance_norm_plain(x, relu=relu)
            got = instance_norm_cuda(x, relu=relu)
            err = float((got - ref).abs().max())
            log("kernels", f"instance_norm f32 {shape} relu={relu}: "
                f"max|err| {err:.3e} (bound 1e-05)")
            if not err <= 1e-5:
                raise AssertionError(f"instance_norm f32 {shape}: {err}")
            # bf16: both sides round mean, scale, x - mean and the product
            # to bf16; an f32 statistic summed in another order can round
            # to the neighbouring bf16 value, which moves x - mean and y by
            # a step each: |err| <= 2^-6 * (|y| + 1), four bf16 steps of y
            xb = x.bfloat16()
            ref = instance_norm_plain(xb, relu=relu).float()
            got = instance_norm_cuda(xb, relu=relu).float()
            err = float((got - ref).abs().max())
            rel = float(((got - ref).abs() / (ref.abs() + 1)).max())
            log("kernels", f"instance_norm bf16 {shape} relu={relu}: "
                f"max|err| {err:.3e}, max|err|/(|y|+1) {rel:.3e} "
                f"(bound {2 ** -6:.3e})")
            if not rel <= 2 ** -6:
                raise AssertionError(f"instance_norm bf16 {shape}: {rel}")
            worst = max(worst, err)
        per = compare_ms(lambda: instance_norm_cuda(xb, relu=True),
                         lambda: instance_norm_plain(xb, relu=True))
        gbs = 3 * xb.numel() * 2 / (per[0] * 1e-3) / 1e9
        log("kernels", f"instance_norm bf16 {shape}: kernel {per[0]:.4f} ms "
            f"({gbs:.0f} GB/s at 3 passes), plain {per[1]:.4f} ms")
    # the entry's times are at the shape of 19 of the 23 calls a forward makes
    RESULTS["instance_norm"] = dict(
        name="instance_norm", route="cuda",
        source="nirgan_tpu_torch/csrc/instance_norm.cu",
        replaces="nirgan_tpu/ops/pallas_kernels.py:130", max_abs_err=worst,
        ms=per[0], plain_ms=per[1])

    # --- C: head conv at (4, 538, 538, 64)
    x = torch.randn((BATCH, SIDE + 6, SIDE + 6, 64), device=dev, generator=g)
    w = torch.randn((1, 64, 7, 7), device=dev, generator=g) / 56.0
    b = torch.full((1,), 0.1, device=dev)
    # f32: a 3136-term sum in another order, then tanh: abs 1e-5; bf16:
    # the plain side rounds conv, bias add and tanh, the kernel once:
    # abs 2^-6 (four bf16 steps near 1)
    for dtype, bound in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        xd = x.to(dtype)
        err = float((head_conv_cuda(xd, w, b).float()
                     - head_conv_plain(xd, w, b).float()).abs().max())
        log("kernels", f"head_conv {dtype}: max|err| {err:.3e} (bound {bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"head_conv {dtype}: {err} > {bound}")
    worst = err  # the bf16 one
    xb = x.bfloat16()
    ms, plain_ms = compare_ms(lambda: head_conv_cuda(xb, w, b),
                              lambda: head_conv_plain(xb, w, b))
    log("kernels", f"head_conv bf16 {tuple(xb.shape)}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    RESULTS["head_conv"] = dict(
        name="head_conv", route="cuda", source="nirgan_tpu_torch/csrc/head_conv.cu",
        replaces="nirgan_tpu/ops/pallas_head.py:135", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms)
    torch.cuda.synchronize()


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
        want = {"trunk_conv": 18, "instance_norm": 23, "head_conv": 1}
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
    if min(on_card.values()) == 0:
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
    if min(launches.values()) == 0:
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
        launches = phase_serving(tmp)
    entries = []
    for name in ("trunk_conv", "instance_norm", "head_conv"):
        entries.append({**RESULTS[name], "launches": launches[name]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
