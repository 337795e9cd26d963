"""Share of the traced training window in which no kernel, copy or fill
ran on the card (the union of its operations against the window)."""


def read(run, cell):
    if run.trace is None or cell.driver != "train" or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
