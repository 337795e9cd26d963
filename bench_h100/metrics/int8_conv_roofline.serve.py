"""Kernel D's share of its roofline in the traced int8 serving window:
every ``igemm_s8_kernel`` launch there is a trunk conv at (batch, side / 4,
side / 4, 4 ngf), whose bound is ``flops.int8_conv_bound_s``; the sum of the
bounds over the kernel's device time."""

from bench_h100 import flops
from bench_h100.flops import down


def read(run, cell):
    if run.trace is None:
        return None
    frag = "igemm_s8_kernel"
    n, t = run.trace.launches(frag), run.trace.time_s(frag)
    if not n or t <= 0:
        return None
    sh = run.shapes
    s2 = down(down(sh["side"]))
    return 100.0 * n * flops.int8_conv_bound_s(sh["batch"], s2, s2, 4 * sh["ngf"]) / t
