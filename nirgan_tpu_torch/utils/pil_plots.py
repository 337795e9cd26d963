"""The port's figures drawn with PIL alone, for installations that have
PIL but not matplotlib.

Each figure function (``utils/logging_helpers.py``: ``plot_tensors``,
``plot_tensors_hist``, ``plot_index``; ``validation/spiders.py``:
``plot_radar_comparison``; ``validation/time_series.py``:
``plot_timeline``; ``utils/plot_clc.py``; ``inference/synthesize.py``'s
example plot) draws with matplotlib, as the JAX package does, where
``has_matplotlib()``; otherwise it draws the same content here: images in
a grid under their titles (a colour map's image normalised to its own range
as ``imshow`` does, or to the range the figure gives it), line charts with
their legend and axis labels, and the radar comparison as one polar panel a
metric with both series' polygons.  The figures are simpler than
matplotlib's (PIL's built-in font, no tick labels but the x axis's names);
what they show is the same.  PIL is imported inside the functions.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["has_matplotlib", "colormap", "listed", "unit_rgb",
           "image_grid", "line_chart", "caption", "stack", "radar_panels"]

# ColorBrewer's RdYlGn, the 11 anchors of matplotlib's "RdYlGn" map, which
# interpolates linearly between them
_RDYLGN = np.array([
    (165, 0, 38), (215, 48, 39), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (217, 239, 139), (166, 217, 106), (102, 189, 99),
    (26, 152, 80), (0, 104, 55)], np.float64)
# matplotlib's "viridis" at 0, 0.1, ..., 1 and "gray", interpolated linearly
_VIRIDIS = np.array([
    (68, 1, 84), (72, 36, 117), (65, 68, 135), (53, 95, 141), (42, 120, 142),
    (33, 145, 140), (34, 168, 132), (68, 191, 112), (122, 209, 81), (189, 223, 38),
    (253, 231, 37)], np.float64)
_GRAY = np.array([(0, 0, 0), (255, 255, 255)], np.float64)
_MAPS = {"RdYlGn": _RDYLGN, "viridis": _VIRIDIS, "gray": _GRAY}
# matplotlib's first two colours of its default cycle
SERIES_COLOURS = ((31, 119, 180), (255, 127, 14))
_PAD, _TITLE = 8, 24


def has_matplotlib() -> bool:
    """Whether matplotlib imports here: the figures' route."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def colormap(img: np.ndarray, name: str = "RdYlGn", vmin: float | None = None,
             vmax: float | None = None) -> np.ndarray:
    """(H, W) floats -> (H, W, 3) uint8 through the colour map ``name``
    (RdYlGn, viridis or gray), normalised to [vmin, vmax], by default the
    image's own min and max (``imshow``'s default)."""
    img = np.asarray(img, np.float64)
    anchors = _MAPS[name]
    lo = float(img.min()) if vmin is None else vmin
    hi = float(img.max()) if vmax is None else vmax
    t = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    pos = np.clip(t, 0.0, 1.0) * (len(anchors) - 1)
    i = np.minimum(pos.astype(np.int64), len(anchors) - 2)
    f = (pos - i)[..., None]
    rgb = anchors[i] * (1.0 - f) + anchors[i + 1] * f
    return np.round(rgb).astype(np.uint8)


def listed(img: np.ndarray, colours: list, vmin: float, vmax: float) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 through a list of "#rrggbb" colours,
    as matplotlib's ``ListedColormap`` maps [vmin, vmax] onto them."""
    table = np.array([[int(c[k:k + 2], 16) for k in (1, 3, 5)] for c in colours],
                     np.uint8)
    t = (np.asarray(img, np.float64) - vmin) / (vmax - vmin)
    return table[np.clip((t * len(table)).astype(np.int64), 0, len(table) - 1)]


def unit_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] -> uint8, as ``imshow`` shows them."""
    return np.round(np.clip(np.asarray(img, np.float64), 0, 1) * 255).astype(np.uint8)


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


def line_chart(series: list, labels: list, x_names: list | None = None,
               x: np.ndarray | None = None, xlabel: str = "", ylabel: str = "",
               size: tuple = (480, 360), markers: bool = False,
               colours: tuple = SERIES_COLOURS) -> np.ndarray:
    """A line chart as an (H, W, 3) uint8 array of ``size`` (W, H), at least
    240 x 180: each of ``series`` (values
    over ``x``, by default 0 .. n - 1) in ``colours`` (matplotlib's default
    cycle), with a dot at each point if ``markers``, a legend of
    ``labels``, the axis labels and, under the axis, ``x_names`` at their
    points."""
    from PIL import Image, ImageDraw

    w, h = max(size[0], 240), max(size[1], 180)  # room for the labels
    img = Image.new("RGB", (w, h), "white")
    draw = ImageDraw.Draw(img)
    left, right, top, bottom = 52, w - 12, 24, h - (52 if x_names else 36)
    draw.rectangle([left, top, right, bottom], outline="black")
    values = [np.asarray(v, np.float64) for v in series]
    xs = np.asarray(np.arange(len(values[0])) if x is None else x, np.float64)
    finite = np.concatenate([v[np.isfinite(v)] for v in values])
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    margin = 0.5 if hi <= lo else 0.05 * (hi - lo)
    lo, hi = lo - margin, hi + margin
    x0 = float(xs.min())
    x1 = float(xs.max()) if xs.max() > x0 else x0 + 1.0

    def at(xv, yv):
        return (left + (xv - x0) / (x1 - x0) * (right - left),
                bottom - (yv - lo) / (hi - lo) * (bottom - top))

    for k, v in enumerate(values):
        colour = colours[k % len(colours)]
        pts = [at(a, b) for a, b in zip(xs, v) if np.isfinite(b)]
        if len(pts) > 1:
            draw.line(pts, fill=colour, width=2)
        if markers:
            for px, py in pts:
                draw.ellipse([px - 3, py - 3, px + 3, py + 3], fill=colour)
        _text(draw, (right - 150, top + 12 + 14 * k), labels[k], colour, centred=False)
    for name, xv in zip(x_names or [], xs):
        _text(draw, (at(xv, lo)[0], bottom + 12), str(name), "black")
    _text(draw, ((left + right) / 2, h - 12), xlabel, "black")
    _text(draw, (left, top / 2), ylabel, "black", centred=False)
    _text(draw, (left / 2, top + 6), f"{hi:.3g}", "grey")
    _text(draw, (left / 2, bottom - 6), f"{lo:.3g}", "grey")
    return np.asarray(img)


def caption(text: str, width: int):
    """A white strip of ``width`` with ``text`` centred: a figure's title."""
    from PIL import Image, ImageDraw

    out = Image.new("RGB", (width, _TITLE), "white")
    _text(ImageDraw.Draw(out), (width / 2, _TITLE / 2), text, "black")
    return out


def stack(images: list):
    """PIL images one above the other, left-aligned, on white."""
    from PIL import Image

    out = Image.new("RGB", (max(i.width for i in images), sum(i.height for i in images)),
                    "white")
    y = 0
    for im in images:
        out.paste(im, (0, y))
        y += im.height
    return out
