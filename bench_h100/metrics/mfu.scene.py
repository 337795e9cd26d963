"""The scene window's generator operations as a share of the card's bf16
peak: each completed window's forward (``flops.serve_seconds_at_peak``, the
inject plane's dense layer included), over the window's wall time."""

from bench_h100 import flops


def read(run, cell):
    if cell.driver != "scene" or not run.work:
        return None
    return 100.0 * flops.serve_seconds_at_peak(run.shapes) * run.work / run.window_s
