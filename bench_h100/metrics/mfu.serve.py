"""The bulk serving window's generator operations as a share of the card's
peak: each completed tile's forward at the peak of the precision each
layer runs in (``flops.serve_seconds_at_peak``), over the window's wall
time."""

from bench_h100 import flops


def read(run, cell):
    if cell.driver != "serve" or not run.work:
        return None
    return 100.0 * flops.serve_seconds_at_peak(run.shapes) * run.work / run.window_s
