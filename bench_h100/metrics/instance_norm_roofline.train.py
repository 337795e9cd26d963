"""Kernels B and B4's share of their roofline in the traced training
steps: the bytes a step's norms must move (``flops.
instance_norm_bytes_train_step``) times the traced steps at the memory
rate, over the device time of every ``csrc/instance_norm.cu`` kernel."""

from bench_h100 import flops

KERNELS = ("in_resident_kernel", "in_partial_kernel", "in_apply_kernel", "in_fold_kernel")


def read(run, cell):
    if run.trace is None or cell.driver != "train":
        return None
    t = run.trace.time_s(*KERNELS)
    if t <= 0:
        return None
    moved = flops.instance_norm_bytes_train_step(run.shapes) * run.trace.units
    return 100.0 * moved / flops.PEAK_BYTES_PER_S / t
