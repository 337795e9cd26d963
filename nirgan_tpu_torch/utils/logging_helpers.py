"""Host-side image panels for the validation log: the port's own copy of
``plot_tensors``, ``plot_tensors_hist`` and ``plot_index`` from
``nirgan_tpu/utils/logging_helpers.py`` (reference
``utils/logging_helpers.py:9-193``).

  * ``plot_tensors``      — RGB | NIR | predicted-NIR rows (RdYlGn), the
    spider sweep's example panels; drawn with PIL
    (``utils/pil_plots.py``) where matplotlib is not installed.
  * ``plot_tensors_hist`` — 4-panel row + intensity histogram, with the
    reference's quirks kept: 1.5× NIR display stretch (:71), center-crop to
    240 (inputs < 350 px) else 500 (:80-83), 100-bin histograms, viridis.
  * ``plot_index``        — NDVI(actual) vs NDVI(pred) panels (RdYlGn),
    clipped to [-1, 1] then displayed on [0, 1].

Inputs are NCHW float arrays in [0, 1] (the logging call sites' contract,
``model/pix2pix.py:286-298``); each returns a PIL image.  matplotlib and PIL
are imported inside the functions, so the module imports without them and
a missing one raises ``ImportError`` at the call (``plot_tensors`` then
draws with PIL).
"""

from __future__ import annotations

import io

import numpy as np

from nirgan_tpu_torch.data.normalise import minmax_percentile

__all__ = ["plot_tensors", "plot_tensors_hist", "plot_index"]


def _figure_to_pil(fig, dpi=100):
    import matplotlib.pyplot as plt
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi)
    buf.seek(0)
    img = Image.open(buf).copy()
    plt.close(fig)
    buf.close()
    return img


def _prep(rgb, nir, pred, max_rows=5):
    rgb = np.clip(np.asarray(rgb, np.float32), 0, 1)
    nir = np.clip(np.asarray(nir, np.float32), 0, 1)
    pred = np.clip(np.asarray(pred, np.float32), 0, 1)
    n = min(pred.shape[0], max_rows)
    return rgb[:n], nir[:n], pred[:n], n


def plot_tensors(rgb, nir, pred_nir, title="Train"):
    try:
        import matplotlib
    except ImportError:
        return _plot_tensors_pil(rgb, nir, pred_nir)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb, nir, pred, n = _prep(rgb, nir, pred_nir)
    rgb = minmax_percentile(rgb, perc=2)
    fig, axes = plt.subplots(n, 3, figsize=(15, 5 * n), squeeze=False)
    for i in range(n):
        axes[i, 0].imshow(np.transpose(rgb[i], (1, 2, 0)))
        axes[i, 1].imshow(nir[i, 0], cmap="RdYlGn")
        axes[i, 2].imshow(pred[i, 0], cmap="RdYlGn")
        for ax in axes[i]:
            ax.set_xticks([]), ax.set_yticks([])
    for ax, t in zip(axes[0], ["RGB Image", "NIR Image", "Predicted NIR Image"]):
        ax.set_title(t)
    fig.tight_layout()
    return _figure_to_pil(fig)


def _plot_tensors_pil(rgb, nir, pred_nir):
    """``plot_tensors``'s panels without matplotlib: the same rows, drawn
    by ``pil_plots.image_grid``."""
    from nirgan_tpu_torch.utils.pil_plots import image_grid, rdylgn

    rgb, nir, pred, n = _prep(rgb, nir, pred_nir)
    rgb = minmax_percentile(rgb, perc=2)
    rows = [[np.round(np.clip(np.transpose(rgb[i], (1, 2, 0)), 0, 1) * 255)
             .astype(np.uint8), rdylgn(nir[i, 0]), rdylgn(pred[i, 0])]
            for i in range(n)]
    return image_grid(rows, ["RGB Image", "NIR Image", "Predicted NIR Image"])


def _center_crop_nchw(x, size):
    h, w = x.shape[-2:]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return x[..., y0:y0 + size, x0:x0 + size]


def plot_tensors_hist(rgb, nir, pred_nir, title="Validation"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # display stretch + crop quirks preserved (reference :71, :80-83)
    nir = np.asarray(nir, np.float32) * 1.5
    pred_nir = np.asarray(pred_nir, np.float32) * 1.5
    rgb, nir, pred, n = _prep(rgb, nir, pred_nir)
    rgb = minmax_percentile(rgb, perc=2)
    crop = 240 if rgb.shape[-1] < 350 else 500
    crop = min(crop, rgb.shape[-1], rgb.shape[-2])
    rgb, nir, pred = (_center_crop_nchw(a, crop) for a in (rgb, nir, pred))

    fig, axes = plt.subplots(n, 4, figsize=(20, 5 * n), squeeze=False)
    bins = np.linspace(0, 1, 101)
    centers = (bins[:-1] + bins[1:]) / 2
    for i in range(n):
        axes[i, 0].imshow(np.transpose(rgb[i], (1, 2, 0)))
        axes[i, 1].imshow(nir[i, 0], cmap="viridis")
        axes[i, 2].imshow(pred[i, 0], cmap="viridis")
        total = nir[i, 0].size
        axes[i, 3].plot(centers, np.histogram(nir[i, 0], bins=bins)[0] / total, color="blue")
        axes[i, 3].plot(centers, np.histogram(pred[i, 0], bins=bins)[0] / total, color="red")
        axes[i, 3].legend(["Real NIR", "Predicted NIR"])
        axes[i, 3].set_xlabel("Pixel Intensity")
        axes[i, 3].set_ylabel("Value Frequency")
    for ax, t in zip(axes[0], ["RGB Image", "NIR Image", "Predicted NIR Image",
                               "NIR/ predNIR Histogram"]):
        ax.set_title(t)
    fig.tight_layout()
    return _figure_to_pil(fig)


def plot_index(rgb, nir, pred_nir, title="Validation", index_name="NDVI"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb = np.asarray(rgb, np.float32)
    nir = np.asarray(nir, np.float32)
    pred = np.asarray(pred_nir, np.float32)
    n = min(pred.shape[0], 5)
    fig, axes = plt.subplots(n, 3, figsize=(15, 5 * n), squeeze=False)
    for i in range(n):
        red = rgb[i, 0]
        ndvi = np.clip((nir[i, 0] - red) / (nir[i, 0] + red + 1e-6), -1, 1)
        ndvi_p = np.clip((pred[i, 0] - red) / (pred[i, 0] + red + 1e-6), -1, 1)
        axes[i, 0].imshow(np.transpose(minmax_percentile(rgb[i], 2), (1, 2, 0)))
        axes[i, 1].imshow((ndvi + 1) / 2, cmap="RdYlGn")
        axes[i, 2].imshow((ndvi_p + 1) / 2, cmap="RdYlGn")
    for ax, t in zip(axes[0], ["RGB Image", f"{index_name} (Actual)",
                               f"{index_name} (Predicted)"]):
        ax.set_title(t)
    fig.tight_layout()
    return _figure_to_pil(fig, dpi=50)
