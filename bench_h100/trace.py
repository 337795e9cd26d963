"""The traced window: ``torch.profiler`` over a few steps or batches after
the measured window, reduced to device time by kernel name and group, the
device's busy time (the union of every kernel, copy and fill on its
timeline) and its idle gaps, each labelled by the benchmark's own host span
that was open at the time.

``GROUPS`` is a frozen copy of ``chip_smoke.py``'s ``PROFILE_GROUPS``: a
kernel's group is the first whose fragment is in its name.
"""

from __future__ import annotations

import torch

from bench_h100.timing import synchronize

GROUPS = (
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
NAME_CHARS = 100


def group_of(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name), "other")


class DeviceTrace:
    """Device operations ``(name, start_ns, end_ns)`` and the benchmark's
    host spans inside one traced window of ``units`` steps or batches."""

    def __init__(self, ops: list, spans: list, window: tuple, units: int):
        self.t0, self.t1 = window
        self.ops = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in ops
                    if b > self.t0 and a < self.t1]
        self.spans = spans
        self.units = units
        self._busy = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self) -> list:
        """The union of the device's operations as disjoint intervals."""
        out: list = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        if self._busy is None:
            self._busy = sum(b - a for a, b in self.merged()) / 1e9
        return self._busy

    def select(self, *fragments: str) -> list:
        return [o for o in self.ops if any(f in o[0] for f in fragments)]

    def time_s(self, *fragments: str) -> float:
        return sum(b - a for _, a, b in self.select(*fragments)) / 1e9

    def launches(self, *fragments: str) -> int:
        return len(self.select(*fragments))

    def group_time_s(self, *groups: str) -> float:
        return sum(b - a for n, a, b in self.ops if group_of(n) in groups) / 1e9

    def label(self, t: int) -> str:
        """The innermost benchmark span open at ``t`` (ns)."""
        open_ = [s for s in self.spans if s[1] <= t < s[2]]
        return max(open_, key=lambda s: s[1])[0] if open_ else "none"

    def idle_gaps(self) -> list:
        """(label, seconds) of every interval of the window in which no
        operation ran on the device."""
        edges = [self.t0] + [x for iv in self.merged() for x in iv] + [self.t1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((self.label((a + b) // 2), (b - a) / 1e9))
        return gaps

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, a, b in self.ops:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def profile(fn, device: torch.device) -> DeviceTrace:
    """Run ``fn()`` (which returns the steps or batches it ran) under the
    profiler, the device synchronised inside the window's own span."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    synchronize(device)
    with _profile(activities=acts) as prof:
        with record_function("bench/window"):
            units = fn()
            synchronize(device)
    ops, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and fills; the host's ranges projected onto
            # the device's timeline are not device work
            if not ev.is_user_annotation() and not name.startswith("bench/"):
                ops.append((name, a, b))
        elif name == "bench/window":
            window = (a, b)
        elif name.startswith("bench/"):
            spans.append((name[len("bench/"):], a, b))
    spans.sort(key=lambda s: s[1])
    return DeviceTrace(ops, spans, window, units)

