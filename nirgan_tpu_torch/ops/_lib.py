"""Build, load and call the port's CUDA kernels (``nirgan_tpu_torch/csrc``).

The sources are compiled at first use by ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``nirgan_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module.

Every C entry point takes the device index and the stream, launches on that
stream without synchronising, and returns ``cudaGetLastError()``;
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
SOURCES = ("trunk_conv.cu", "instance_norm.cu", "head_conv.cu",
           "convt_bwd.cu", "igemm_wgmma.cu", "int8_conv.cu", "int8_norm.cu",
           "reflect_pad.cu")
HEADERS = ("hopper.cuh", "igemm_wgmma.h")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each entry point: pointers and the stream as c_void_p (a plain
# int would be cut to 32 bits)
_SIGNATURES = {
    "nirgan_trunk_conv": (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P),
    "nirgan_instance_norm": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _I, _P),
    "nirgan_instance_norm_bwd": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P),
    "nirgan_instance_norm_max_clusters": (_I, _I, _I, _I, _I, _I, _I, _I),
    "nirgan_instance_norm_sums": (_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nirgan_instance_norm_apply": (_I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P),
    "nirgan_head_conv": (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nirgan_convt_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P),
    "nirgan_int8_conv": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    "nirgan_int8_norm": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P),
    "nirgan_int8_norm_blocks_per_sm": (_I, _I, _I, _I),
    "nirgan_reflect_pad": (_I, _I, _P, _P, _I, _I, _I, _I, _P),
    "nirgan_reflect_pad_adjoint": (_I, _I, _P, _P, _I, _I, _I, _I, _P),
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libnirgan_kernels_{_digest()}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the keyed library exists.  Returns its
    path, the seconds spent compiling (0 when it was already built) and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to private names, then rename: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, Path(s).stem + ".o") for s in SOURCES]
        logs = [obj + ".txt" for obj in objs]
        procs = []
        for src, obj, txt in zip(SOURCES, objs, logs):
            with open(txt, "w") as sink:  # a file: no pipe to fill up
                procs.append(subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                    stdout=sink, stderr=subprocess.STDOUT))
        codes = [p.wait() for p in procs]
        outputs = [Path(txt).read_text() for txt in logs]
        failed = [f"{src} ({rc}):\n{text}" for src, rc, text
                  in zip(SOURCES, codes, outputs) if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, out.name)
        link = subprocess.run([nvcc(), *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    report = "".join(outputs)
    log.write_text(report)
    return out, time.perf_counter() - t0, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def route(x: torch.Tensor, name: str) -> bool:
    """The dispatch rule of every op with a kernel: True for a CUDA tensor
    (launch the kernel), False for a CPU tensor (the plain version); any
    other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel and no plain route for device "
                       f"{x.device}")


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def stream_of(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def dtype_code(x: torch.Tensor, name: str) -> int:
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, "
                     "bfloat16)")


def aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
