"""CORINE land-cover (CLC) mask visualisations, the port's own copy of
``nirgan_tpu/utils/plot_clc.py`` (reference
``utils/plot_clc_pred.py`` + ``utils/plot_clc_utils.py``): RGB / NIR /
predicted-NIR / 5-class CLC mask panels with the fixed class colormap
(0 background, 1 agricultural, 2 natural vegetation, 3 water, 4 artificial).

Differences from the reference: output paths are parameters instead of
hardcoded absolute paths (``plot_clc_pred.py:57``), and the figures are
returned as PIL images in addition to optional saving.  Where matplotlib
is not installed the same panels are drawn with PIL
(``utils/pil_plots.py``).
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from nirgan_tpu_torch.utils.pil_plots import has_matplotlib

__all__ = ["plot_rgb_nir_and_mask", "plot_rgb_and_mask", "CLC_COLORS"]

CLC_COLORS = [
    "#ffffff",  # 0: background / no class
    "#90ee90",  # 1: agricultural
    "#006400",  # 2: natural vegetation
    "#1e90ff",  # 3: water
    "#ff0000",  # 4: artificial surfaces
]


def _save(img, out_path: Optional[str]):
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        img.save(out_path)
    return img


def _finish(fig, out_path: Optional[str], dpi: int = 150):
    import matplotlib.pyplot as plt
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi)
    buf.seek(0)
    img = Image.open(buf).copy()
    plt.close(fig)
    return _save(img, out_path)


def _panels(panels, title: Optional[str], out_path: Optional[str], size: tuple):
    """``panels`` [(image, title, imshow keywords)] side by side under
    ``title``: JAX's matplotlib figure of ``size`` inches, or where
    matplotlib is not installed the same images drawn with PIL (a
    ``cmap`` of "viridis" or the CLC classes' ``ListedColormap`` over the
    keywords' vmin and vmax)."""
    if not has_matplotlib():
        from nirgan_tpu_torch.utils.pil_plots import (
            caption,
            colormap,
            image_grid,
            listed,
            stack,
            unit_rgb,
        )

        def draw(img, kw):
            if "cmap" not in kw:
                return unit_rgb(img)
            if kw["cmap"] == "clc":
                return listed(img, CLC_COLORS, kw["vmin"], kw["vmax"])
            return colormap(img, kw["cmap"], kw["vmin"], kw["vmax"])

        grid = image_grid([[draw(img, kw) for img, _, kw in panels]],
                          [t for _, t, _ in panels])
        if title:
            grid = stack([caption(title, grid.width), grid])
        return _save(grid, out_path)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    fig, axs = plt.subplots(1, len(panels), figsize=size)
    for ax, (img, t, kw) in zip(axs, panels):
        if kw.get("cmap") == "clc":
            kw = {**kw, "cmap": ListedColormap(CLC_COLORS)}
        ax.imshow(img, **kw)
        ax.set_title(t)
        ax.axis("off")
    if title:
        fig.suptitle(title)
    return _finish(fig, out_path)


def plot_rgb_nir_and_mask(rgb, nir, pred_nir, mask, it: int = 0,
                          title: Optional[str] = None,
                          out_dir: Optional[str] = None):
    """rgb (3,H,W), nir/pred (1|H,W), mask (H,W) int → 4-panel figure."""
    rgb_np = np.clip(np.transpose(np.asarray(rgb, np.float32), (1, 2, 0)) * 5, 0, 1)
    nir_np = np.squeeze(np.asarray(nir, np.float32))
    pred_np = np.squeeze(np.asarray(pred_nir, np.float32))
    out = os.path.join(out_dir, f"clc_mask_{it}.png") if out_dir else None
    return _panels([
        (rgb_np, "RGB", {}),
        (nir_np, "Ground Truth NIR", dict(cmap="viridis", vmin=0, vmax=1)),
        (pred_np, "Predicted NIR", dict(cmap="viridis", vmin=0, vmax=1)),
        (np.asarray(mask), "CLC Mask", dict(cmap="clc", vmin=0, vmax=4)),
    ], title, out, (20, 6))


def plot_rgb_and_mask(rgb, mask, it: int = 0, title: Optional[str] = None,
                      out_dir: Optional[str] = None):
    rgb_np = np.clip(np.transpose(np.asarray(rgb, np.float32), (1, 2, 0)) * 5, 0, 1)
    out = os.path.join(out_dir, f"clc_mask_{it}.png") if out_dir else None
    return _panels([(rgb_np, "RGB Image", {}),
                    (np.asarray(mask), "CLC Mask", dict(cmap="clc", vmin=0, vmax=4))],
                   title, out, (10, 5))
