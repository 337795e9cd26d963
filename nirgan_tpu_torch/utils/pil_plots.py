"""The validation figures drawn with PIL alone, for installations that
have PIL but not matplotlib.

``plot_tensors`` (``utils/logging_helpers.py``) and
``plot_radar_comparison`` (``validation/spiders.py``) draw with matplotlib,
as the JAX package does, where it can be imported; otherwise they draw the
same content here: the example panels as a grid of images (RGB as it is,
NIR and predicted NIR through the RdYlGn colour map, each normalised to
its own range as ``imshow`` does), and the radar comparison as one polar
panel a metric with both series' polygons.  The figures are simpler than
matplotlib's (PIL's built-in font, no tick labels); what they show is the
same.  PIL is imported inside the functions.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["rdylgn", "image_grid", "radar_panels"]

# ColorBrewer's RdYlGn, the 11 anchors of matplotlib's "RdYlGn" map, which
# interpolates linearly between them
_RDYLGN = np.array([
    (165, 0, 38), (215, 48, 39), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (217, 239, 139), (166, 217, 106), (102, 189, 99),
    (26, 152, 80), (0, 104, 55)], np.float64)
# matplotlib's first two colours of its default cycle
SERIES_COLOURS = ((31, 119, 180), (255, 127, 14))
_PAD, _TITLE = 8, 24


def rdylgn(img: np.ndarray) -> np.ndarray:
    """(H, W) floats -> (H, W, 3) uint8 through RdYlGn, normalised to the
    image's own min and max (``imshow``'s default)."""
    img = np.asarray(img, np.float64)
    lo, hi = float(img.min()), float(img.max())
    t = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    pos = np.clip(t, 0.0, 1.0) * (len(_RDYLGN) - 1)
    i = np.minimum(pos.astype(np.int64), len(_RDYLGN) - 2)
    f = (pos - i)[..., None]
    rgb = _RDYLGN[i] * (1.0 - f) + _RDYLGN[i + 1] * f
    return np.round(rgb).astype(np.uint8)


def image_grid(rows: list, titles: list):
    """A PIL image of ``rows`` (lists of (H, W, 3) uint8 arrays, one per
    column) under one line of column ``titles``."""
    from PIL import Image, ImageDraw

    h = max(cell.shape[0] for row in rows for cell in row)
    w = max(cell.shape[1] for row in rows for cell in row)
    cols = max(len(row) for row in rows)
    out = Image.new("RGB", (_PAD + cols * (w + _PAD),
                            _TITLE + _PAD + len(rows) * (h + _PAD)), "white")
    draw = ImageDraw.Draw(out)
    for j, title in enumerate(titles):
        draw.text((_PAD + j * (w + _PAD), _PAD // 2), title, fill="black")
    for i, row in enumerate(rows):
        for j, cell in enumerate(row):
            out.paste(Image.fromarray(np.ascontiguousarray(cell)),
                      (_PAD + j * (w + _PAD), _TITLE + _PAD + i * (h + _PAD)))
    return out


def _text(draw, xy, text: str, fill, centred: bool = True) -> None:
    """``text`` centred on ``xy`` (or starting at it, centred in height):
    placed from its box, which works with PIL's bitmap font too (anchors
    need a TrueType one)."""
    left, top, right, bottom = draw.textbbox((0, 0), text)
    x = xy[0] - (right - left) / 2 if centred else xy[0]
    draw.text((x, xy[1] - (bottom - top) / 2), text, fill=fill)


def _dashed(draw, points, fill, width: int, dash: float = 8.0) -> None:
    """A polyline drawn in dashes of ``dash`` pixels."""
    for (x0, y0), (x1, y1) in zip(points[:-1], points[1:]):
        n = max(1, int(math.hypot(x1 - x0, y1 - y0) // dash))
        for k in range(0, n, 2):
            a, b = k / n, min(k + 1, n) / n
            draw.line([(x0 + (x1 - x0) * a, y0 + (y1 - y0) * a),
                       (x0 + (x1 - x0) * b, y0 + (y1 - y0) * b)],
                      fill=fill, width=width)


def radar_panels(categories: list, metrics: list, series: list, labels,
                 size: int = 600):
    """One polar panel a metric, side by side: a spoke per category
    (counter-clockwise from the east, as matplotlib's polar axes), the
    first series solid and the second dashed, radius 0 at the centre and
    the panel's largest finite value near the rim.  ``series[k][m]`` holds
    series k's values of metric m, one a category (NaN: no point)."""
    from PIL import Image, ImageDraw

    n = len(categories)
    out = Image.new("RGB", (size * len(metrics), size), "white")
    draw = ImageDraw.Draw(out)
    radius = size * 0.36
    for m, metric in enumerate(metrics):
        cx, cy = size * m + size / 2, size / 2 + 10
        values = [np.asarray(s[m], np.float64) for s in series]
        finite = np.concatenate([v[np.isfinite(v)] for v in values])
        top = float(finite.max()) * 1.05 if finite.size and finite.max() > 0 else 1.0
        for ring in (0.25, 0.5, 0.75, 1.0):
            r = radius * ring
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=(200, 200, 200))
        angles = [2 * math.pi * i / n for i in range(n)]
        for a, name in zip(angles, categories):
            x, y = cx + radius * math.cos(a), cy - radius * math.sin(a)
            draw.line([(cx, cy), (x, y)], fill=(200, 200, 200))
            tx = cx + (radius + 24) * math.cos(a)
            ty = cy - (radius + 24) * math.sin(a)
            _text(draw, (tx, ty), str(name), "grey")
        _text(draw, (cx, 20), metric.upper(), "black")
        for k, v in enumerate(values):
            pts = [(cx + radius * val / top * math.cos(a),
                    cy - radius * val / top * math.sin(a))
                   for a, val in zip(angles, v) if np.isfinite(val)]
            colour = SERIES_COLOURS[k % len(SERIES_COLOURS)]
            if len(pts) > 1:
                pts.append(pts[0])
                if k == 0:
                    draw.line(pts, fill=colour, width=2)
                else:
                    _dashed(draw, pts, colour, 2)
            ly = size - 40 + 16 * k
            draw.line([(size * m + 20, ly), (size * m + 50, ly)], fill=colour, width=2)
            _text(draw, (size * m + 58, ly), labels[k], "black", centred=False)
    return out
