"""Host ms a serving batch spent in the loader's next batch and the
task's ``_ingest`` (the pinned copies to the card), the mean over the
measured window's batches."""


def read(run, cell):
    seconds, n = run.spans.get("load_batch", (0.0, 0))
    return 1e3 * seconds / n if n else None
