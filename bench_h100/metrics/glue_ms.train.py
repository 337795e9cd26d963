"""Device ms a training step spends in layout copies, casts and reflect
pads (the groups "copies (layout, casts)", "cuDNN layout" and "reflect
pad" of ``trace.GROUPS``), over the traced steps."""

GLUE = ("copies (layout, casts)", "cuDNN layout", "reflect pad")


def read(run, cell):
    if run.trace is None or cell.driver != "train" or not run.trace.ops:
        return None
    return 1e3 * run.trace.group_time_s(*GLUE) / run.trace.units
