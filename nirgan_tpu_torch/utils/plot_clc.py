"""CORINE land-cover (CLC) mask visualisations, the port's own copy of
``nirgan_tpu/utils/plot_clc.py`` (reference
``utils/plot_clc_pred.py`` + ``utils/plot_clc_utils.py``): RGB / NIR /
predicted-NIR / 5-class CLC mask panels with the fixed class colormap
(0 background, 1 agricultural, 2 natural vegetation, 3 water, 4 artificial).

Differences from the reference: output paths are parameters instead of
hardcoded absolute paths (``plot_clc_pred.py:57``), and the figures are
returned as PIL images in addition to optional saving.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

__all__ = ["plot_rgb_nir_and_mask", "plot_rgb_and_mask", "CLC_COLORS"]

CLC_COLORS = [
    "#ffffff",  # 0: background / no class
    "#90ee90",  # 1: agricultural
    "#006400",  # 2: natural vegetation
    "#1e90ff",  # 3: water
    "#ff0000",  # 4: artificial surfaces
]


def _finish(fig, out_path: Optional[str], dpi: int = 150):
    import matplotlib.pyplot as plt
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi)
    buf.seek(0)
    img = Image.open(buf).copy()
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        img.save(out_path)
    plt.close(fig)
    return img


def plot_rgb_nir_and_mask(rgb, nir, pred_nir, mask, it: int = 0,
                          title: Optional[str] = None,
                          out_dir: Optional[str] = None):
    """rgb (3,H,W), nir/pred (1|H,W), mask (H,W) int → 4-panel figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    rgb_np = np.clip(np.transpose(np.asarray(rgb, np.float32), (1, 2, 0)) * 5, 0, 1)
    nir_np = np.squeeze(np.asarray(nir, np.float32))
    pred_np = np.squeeze(np.asarray(pred_nir, np.float32))
    mask_np = np.asarray(mask)
    cmap = ListedColormap(CLC_COLORS)

    fig, axs = plt.subplots(1, 4, figsize=(20, 6))
    for ax, (img, t, kw) in zip(axs, [
        (rgb_np, "RGB", {}),
        (nir_np, "Ground Truth NIR", dict(cmap="viridis", vmin=0, vmax=1)),
        (pred_np, "Predicted NIR", dict(cmap="viridis", vmin=0, vmax=1)),
        (mask_np, "CLC Mask", dict(cmap=cmap, vmin=0, vmax=4)),
    ]):
        ax.imshow(img, **kw)
        ax.set_title(t)
        ax.axis("off")
    if title:
        fig.suptitle(title)
    out = os.path.join(out_dir, f"clc_mask_{it}.png") if out_dir else None
    return _finish(fig, out)


def plot_rgb_and_mask(rgb, mask, it: int = 0, title: Optional[str] = None,
                      out_dir: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    rgb_np = np.clip(np.transpose(np.asarray(rgb, np.float32), (1, 2, 0)) * 5, 0, 1)
    mask_np = np.asarray(mask)
    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    axs[0].imshow(rgb_np)
    axs[0].set_title("RGB Image")
    axs[0].axis("off")
    axs[1].imshow(mask_np, cmap=ListedColormap(CLC_COLORS), vmin=0, vmax=4)
    axs[1].set_title("CLC Mask")
    axs[1].axis("off")
    if title:
        fig.suptitle(title)
    out = os.path.join(out_dir, f"clc_mask_{it}.png") if out_dir else None
    return _finish(fig, out)
