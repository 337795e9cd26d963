"""Host-side image panels for the validation log: the port's own copy of
``plot_tensors``, ``plot_tensors_hist`` and ``plot_index`` from
``nirgan_tpu/utils/logging_helpers.py`` (reference
``utils/logging_helpers.py:9-193``).

  * ``plot_tensors``      — RGB | NIR | predicted-NIR rows (RdYlGn), the
    spider sweep's example panels.
  * ``plot_tensors_hist`` — 4-panel row + intensity histogram, with the
    reference's quirks kept: 1.5× NIR display stretch (:71), center-crop to
    240 (inputs < 350 px) else 500 (:80-83), 100-bin histograms, viridis.
  * ``plot_index``        — NDVI(actual) vs NDVI(pred) panels (RdYlGn),
    clipped to [-1, 1] then displayed on [0, 1].

Inputs are NCHW float arrays in [0, 1] (the logging call sites' contract,
``model/pix2pix.py:286-298``); each returns a PIL image: JAX's matplotlib
figure where matplotlib imports, else the same panels drawn with PIL
(``utils/pil_plots.py``).  matplotlib and PIL are imported inside the
functions, so the module imports without them.
"""

from __future__ import annotations

import io

import numpy as np

from nirgan_tpu_torch.data.normalise import minmax_percentile
from nirgan_tpu_torch.utils.pil_plots import has_matplotlib

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
    if not has_matplotlib():
        return _plot_tensors_pil(rgb, nir, pred_nir)
    import matplotlib

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
    from nirgan_tpu_torch.utils.pil_plots import colormap, image_grid, unit_rgb

    rgb, nir, pred, n = _prep(rgb, nir, pred_nir)
    rgb = minmax_percentile(rgb, perc=2)
    rows = [[unit_rgb(np.transpose(rgb[i], (1, 2, 0))), colormap(nir[i, 0]),
             colormap(pred[i, 0])] for i in range(n)]
    return image_grid(rows, ["RGB Image", "NIR Image", "Predicted NIR Image"])


def _center_crop_nchw(x, size):
    h, w = x.shape[-2:]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return x[..., y0:y0 + size, x0:x0 + size]


HIST_TITLES = ["RGB Image", "NIR Image", "Predicted NIR Image", "NIR/ predNIR Histogram"]
HIST_LABELS = ["Real NIR", "Predicted NIR"]


def _hist_panels(rgb, nir, pred_nir):
    """The reference's display stretch and crop (:71, :80-83), and each
    row's two 100-bin histograms over [0, 1] as shares of the pixels: (rgb,
    nir, pred, n, bin centres, [(real, predicted)] a row)."""
    nir = np.asarray(nir, np.float32) * 1.5
    pred_nir = np.asarray(pred_nir, np.float32) * 1.5
    rgb, nir, pred, n = _prep(rgb, nir, pred_nir)
    rgb = minmax_percentile(rgb, perc=2)
    crop = 240 if rgb.shape[-1] < 350 else 500
    crop = min(crop, rgb.shape[-1], rgb.shape[-2])
    rgb, nir, pred = (_center_crop_nchw(a, crop) for a in (rgb, nir, pred))
    bins = np.linspace(0, 1, 101)
    centers = (bins[:-1] + bins[1:]) / 2
    hists = [tuple(np.histogram(a[i, 0], bins=bins)[0] / nir[i, 0].size
                   for a in (nir, pred)) for i in range(n)]
    return rgb, nir, pred, n, centers, hists


def plot_tensors_hist(rgb, nir, pred_nir, title="Validation"):
    rgb, nir, pred, n, centers, hists = _hist_panels(rgb, nir, pred_nir)
    if not has_matplotlib():
        return _plot_tensors_hist_pil(rgb, nir, pred, n, centers, hists)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(n, 4, figsize=(20, 5 * n), squeeze=False)
    for i in range(n):
        axes[i, 0].imshow(np.transpose(rgb[i], (1, 2, 0)))
        axes[i, 1].imshow(nir[i, 0], cmap="viridis")
        axes[i, 2].imshow(pred[i, 0], cmap="viridis")
        axes[i, 3].plot(centers, hists[i][0], color="blue")
        axes[i, 3].plot(centers, hists[i][1], color="red")
        axes[i, 3].legend(HIST_LABELS)
        axes[i, 3].set_xlabel("Pixel Intensity")
        axes[i, 3].set_ylabel("Value Frequency")
    for ax, t in zip(axes[0], HIST_TITLES):
        ax.set_title(t)
    fig.tight_layout()
    return _figure_to_pil(fig)


def _plot_tensors_hist_pil(rgb, nir, pred, n, centers, hists):
    """``plot_tensors_hist``'s panels without matplotlib: RGB, NIR and
    predicted NIR through viridis, and the two histograms (blue and red, as
    the reference's) as a line chart of the images' size."""
    from nirgan_tpu_torch.utils.pil_plots import colormap, image_grid, line_chart, unit_rgb

    size = (rgb.shape[-1], rgb.shape[-2])
    rows = [[unit_rgb(np.transpose(rgb[i], (1, 2, 0))), colormap(nir[i, 0], "viridis"),
             colormap(pred[i, 0], "viridis"),
             line_chart(list(hists[i]), HIST_LABELS, x=centers,
                        xlabel="Pixel Intensity", ylabel="Value Frequency",
                        size=size, colours=((0, 0, 255), (255, 0, 0)))]
            for i in range(n)]
    return image_grid(rows, HIST_TITLES)


def _ndvi_panels(rgb, nir, pred_nir):
    """plot_index's rows: (the RGB stretched by its 2-98 percentiles, the
    actual and the predicted NDVI clipped to [-1, 1] and mapped to [0, 1])."""
    rgb = np.asarray(rgb, np.float32)
    nir = np.asarray(nir, np.float32)
    pred = np.asarray(pred_nir, np.float32)
    rows = []
    for i in range(min(pred.shape[0], 5)):
        red = rgb[i, 0]
        ndvi = np.clip((nir[i, 0] - red) / (nir[i, 0] + red + 1e-6), -1, 1)
        ndvi_p = np.clip((pred[i, 0] - red) / (pred[i, 0] + red + 1e-6), -1, 1)
        rows.append((np.transpose(minmax_percentile(rgb[i], 2), (1, 2, 0)),
                     (ndvi + 1) / 2, (ndvi_p + 1) / 2))
    return rows


def plot_index(rgb, nir, pred_nir, title="Validation", index_name="NDVI"):
    rows = _ndvi_panels(rgb, nir, pred_nir)
    titles = ["RGB Image", f"{index_name} (Actual)", f"{index_name} (Predicted)"]
    if not has_matplotlib():
        from nirgan_tpu_torch.utils.pil_plots import colormap, image_grid, unit_rgb

        return image_grid([[unit_rgb(a), colormap(b), colormap(c)] for a, b, c in rows],
                          titles)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(rows), 3, figsize=(15, 5 * len(rows)), squeeze=False)
    for i, row in enumerate(rows):
        axes[i, 0].imshow(row[0])
        axes[i, 1].imshow(row[1], cmap="RdYlGn")
        axes[i, 2].imshow(row[2], cmap="RdYlGn")
    for ax, t in zip(axes[0], titles):
        ax.set_title(t)
    fig.tight_layout()
    return _figure_to_pil(fig, dpi=50)
