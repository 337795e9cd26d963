"""Host ms a training step waited on the feed (``next`` of the
``DeviceFeed``: the loader's batch and, at depth 0, its staged copy), the
mean over the measured window's steps."""


def read(run, cell):
    seconds, n = run.spans.get("feed", (0.0, 0))
    return 1e3 * seconds / n if n else None
