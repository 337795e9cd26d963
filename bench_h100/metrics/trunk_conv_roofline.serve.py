"""Kernel A's share of its roofline in the traced serving window: every
``igemm_wgmma_kernel`` launch there is a trunk conv at (batch, side / 4,
side / 4, 4 ngf), whose bound is ``flops.trunk_conv_bound_s``; the sum of
the bounds over the kernel's device time."""

from bench_h100 import flops
from bench_h100.flops import down


def read(run, cell):
    if run.trace is None:
        return None
    frag = "igemm_wgmma_kernel"
    n, t = run.trace.launches(frag), run.trace.time_s(frag)
    if not n or t <= 0:
        return None
    sh = run.shapes
    s2 = down(down(sh["side"]))
    return 100.0 * n * flops.trunk_conv_bound_s(sh["batch"], s2, s2, 4 * sh["ngf"]) / t
