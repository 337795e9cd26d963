"""The training window's model FLOP/s as a share of the card's bf16 peak:
the analytic operations of each fused step (``flops.train_step``) times
the window's steps, over its wall time."""

from bench_h100 import flops


def read(run, cell):
    if cell.driver != "train" or not run.units:
        return None
    return 100.0 * flops.train_step(run.shapes) * run.units / run.window_s / flops.PEAK_BF16_FLOPS
