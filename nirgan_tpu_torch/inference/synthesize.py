"""Bulk RGB->NIR synthesis, the serving pipeline; counterpart of
``nirgan_tpu/inference/synthesize.py`` (reference
``create_synthetic_dataset.py:98-124``).

Per batch, on the task's device: DN -> reflectance, on the SatCLIP routes the
tiles' coordinates through the frozen location tower (the embedding feeds
the inject generator, or joins as the concat route's 4th channel),
reflect-pad to the shape bucket, the generator (with its reflect-pad-10), crop, the x4 bilinear
upsample of the S2 NIR followed by a second resize to the prediction size
(the reference's double-interpolation quirk, kept), histogram matching, and
the fp16 cast.  The host only copies the fp16 tiles back and hands them to
writer threads for the compressed ``.npz`` writes.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from nirgan_tpu_torch.inference.histogram import histogram_match
from nirgan_tpu_torch.ops.pad import reflect_pad_to
from nirgan_tpu_torch.ops.resize import resize_bilinear

__all__ = ["synthesize_dataset", "serve_batch"]


def _writer_loop(q: "queue.Queue", out_path: str) -> None:
    while True:
        item = q.get()
        if item is None:
            return
        name, arr = item
        np.savez_compressed(os.path.join(out_path, f"{name}"), nir=arr)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """NCHW numpy batch -> NHWC tensor on ``device``.  uint8/uint16 DN stays
    integer through the copy (half the bytes of f32); anything else becomes
    f32."""
    x = np.asarray(x)
    if x.dtype not in (np.uint8, np.uint16):
        x = np.asarray(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device).permute(0, 2, 3, 1)


@torch.inference_mode()
def serve_batch(task, hr: torch.Tensor, s2: torch.Tensor,
                match_histograms: bool = True, coords=None,
                embeds=None) -> torch.Tensor:
    """One batch of the serving computation: hr (B, H, W, 3) and s2
    (B, h, w, 1) NHWC (DN integers or reflectance) [and, on the SatCLIP
    routes, (B, 2) lon/lat ``coords`` as numpy or the ``embeds`` that
    ``task.embed_coords`` made of them] -> (B, H, W, 1) fp16."""
    h, w = hr.shape[1], hr.shape[2]
    size = task.bucket_for(h, w)
    cond = {"rgb": hr}
    if task.satclip:
        if coords is None and embeds is None:
            raise ValueError("SatCLIP model requires coords (B, 2)")
        cond.update(task.condition(hr, coords, embeds))
    x = reflect_pad_to(task._dn_to_reflectance(cond["rgb"], task.compute_dtype),
                       size, size)
    pred = task.g_apply(x, cond.get("embeds")).float()[:, :h, :w, :]
    if match_histograms:
        s2 = task._dn_to_reflectance(s2, torch.float32)
        up = resize_bilinear(s2, s2.shape[1] * 4, s2.shape[2] * 4)
        up = resize_bilinear(up, h, w)  # double interpolation quirk
        pred = histogram_match(pred, up)
    return pred.to(torch.float16)


def synthesize_dataset(task, dataset, out_path: str, batch_size: int = 8,
                       match_histograms: bool = True, plot_every: int = 10,
                       plot_dir: Optional[str] = None, num_workers: int = 4,
                       num_writers: int = 4) -> int:
    """Run the generator over an LR/HR paired dataset and write synthetic
    NIR tiles (fp16 ``.npz``, key ``nir``); returns the number written.

    ``task``: a ``tasks.Px2PxTask`` with its weights bound.
    ``dataset``: SRPairedDataset-like items {"lr", "hr", "s2_nir",
    "coords", "id"}.  The next batch is queued on the device before the
    previous one is copied back, so the copy and the writes overlap device
    work; the loader's thread runs the SatCLIP tower on a batch's
    coordinates (``task.embed_coords``).
    """
    from nirgan_tpu_torch.data.pipeline import Loader

    os.makedirs(out_path, exist_ok=True)
    loader = Loader(dataset, batch_size, shuffle=False, num_workers=num_workers,
                    drop_last=False, process_index=0, process_count=1,
                    transform=task.embed_coords)
    q: queue.Queue = queue.Queue(maxsize=64)
    writers = [threading.Thread(target=_writer_loop, args=(q, out_path),
                                daemon=True)
               for _ in range(max(1, num_writers))]
    for t in writers:
        t.start()

    n_written = 0

    def flush(item) -> None:
        nonlocal n_written
        dev, ids, batch, v = item
        out = dev.cpu().numpy().transpose(0, 3, 1, 2)
        for im, tid in zip(out, ids):
            q.put((tid, im))
            n_written += 1
        if plot_dir and v % plot_every == 0:
            _plot_example(batch, out, v, plot_dir, dn_scale=task.dn_scale)

    pending = None
    try:
        for v, batch in enumerate(loader):
            hr = _to_device(batch["hr"], task.device)
            s2 = _to_device(batch["s2_nir"], task.device)
            dev = serve_batch(task, hr, s2, match_histograms,
                              embeds=batch.get("embeds"))
            if pending is not None:
                flush(pending)
            pending = (dev, batch["id"], batch, v)
        if pending is not None:
            flush(pending)
    finally:
        for _ in writers:
            q.put(None)
        for t in writers:
            t.join()
    return n_written


def _plot_example(batch, pred_nchw, idx: int, plot_dir: str,
                  dn_scale: float = 10000.0) -> None:
    """4-panel HR-RGB | LR-RGB | synth NIR | real NIR example (reference
    ``plot_example``, ``create_synthetic_dataset.py:54-84``)."""
    try:
        import matplotlib
    except ImportError as e:
        print("example plot skipped:", e)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def refl(x):  # DN passthrough batches carry integers
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return x.astype(np.float32) / float(dn_scale)
        return np.asarray(x, np.float32)

    os.makedirs(plot_dir, exist_ok=True)
    hr = np.clip(refl(batch["hr"][0]) * 3, 0, 1)
    lr = np.clip(refl(batch["lr"][0]) * 3, 0, 1)
    fig, axs = plt.subplots(1, 4, figsize=(16, 4))
    axs[0].imshow(np.transpose(hr, (1, 2, 0)))
    axs[0].set_title("HR RGB")
    axs[1].imshow(np.transpose(lr, (1, 2, 0)))
    axs[1].set_title("LR RGB")
    axs[2].imshow(pred_nchw[0, 0].astype(np.float32), cmap="gray")
    axs[2].set_title("Synth NIR")
    axs[3].imshow(refl(batch["s2_nir"][0, 0]), cmap="gray")
    axs[3].set_title("Real NIR")
    for ax in axs:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"example_{idx}.png"))
    plt.close(fig)
