"""Clocks of the measured window: host spans around the calls into each
layer, and the device's step ends by CUDA events on the compute stream.

The step clock keeps ``chip_smoke.py``'s rule for CUDA events (record on
the stream the work is queued on, read ``elapsed_time`` only after the last
event has completed), applied to consecutive step ends: a step's time is
the interval from the previous step's end, so a feed or a host stall shows
in the step it delays.  On the CPU (the tests) the host clock stands in.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


class Spans:
    """Host time by span name, summed over the window: ``totals[name] =
    [seconds, count]``.  With ``annotate`` each span is also a
    ``torch.profiler.record_function`` range, so a traced window can label
    the device's idle gaps by what the host was doing; with ``on`` false
    (set-up) nothing is recorded."""

    def __init__(self, annotate: bool = False, on: bool = True):
        self.totals: dict = {}
        self.annotate = annotate
        self.on = on

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        rf = (torch.profiler.record_function(f"bench/{name}") if self.annotate
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        acc = self.totals.setdefault(name, [0.0, 0])
        acc[0] += time.perf_counter() - t0
        acc[1] += 1


class StepClock:
    """The end of every step, marked on the device's compute stream."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [self._mark()]

    def step(self) -> None:
        self.marks.append(self._mark())

    def intervals_ms(self) -> list:
        """Each step's ms, after the device has finished the last step."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def p95(values) -> float:
    """The 95th percentile, ``statistics.quantiles``' exclusive method."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
