"""Host ms a scene spent in ``upload_scene`` (the copy of the uint16 scene
to the card and the reflect pad gathered there), the mean over the
measured window's scenes."""


def read(run, cell):
    seconds, n = run.spans.get("upload_scene", (0.0, 0))
    return 1e3 * seconds / n if n else None
