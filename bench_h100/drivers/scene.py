"""The whole-scene cell: ``synthesize_scene``'s two steps as it runs them,
``upload_scene`` (one copy of the uint16 scene, the reflect pad gathered on
the card) and ``blend_scene`` (every window batch cut from it, its SatCLIP
embeddings by the frozen tower on the host, the inject generator, the
weighted blend on the card), then the blended scene copied to the host; a
closed loop over one seeded georeferenced scene.  A window counts once its
scene is on the host.

The frozen tower's weights are the benchmark's, drawn from the seed and
bound into the program's tower (``LocationEncoder``), as the generator's
are.  Set-up serves ``warmup_scenes``; the window keeps one of its scenes'
results, drawn from the seed; after it the program is freed and the
reference serves the scene from the same weights and inputs.  What is
compared, each against its limit in ``workloads/<cell>.json``:

- ``rel_rmse``: the root mean square of the scene's difference over the
  spread of the reference's scene;
- ``embed_gap``: the embeddings the generator was given for the kept
  scene's windows (taken at ``task.g_apply``), the largest difference over
  the largest value of the reference's, which works them out from the
  scene's georeference by its own tower;
- ``plane_gap``: the inject's location plane that the generator made of
  them (taken at ``location_plane``, every ``PLANE_STEP``-th row and
  column), the root mean square of the difference over the reference's.

The two taps are there because the whole scene cannot see the inject: at
the published ``scaling_param_init`` the plane's share is about 0.003,
under half a bfloat16 step at 1, so ``h * (1 + scale * plane)`` rounds to
``h`` nearly everywhere in the program.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import core, traffic as traffic_mod, trace as trace_mod, weights
from bench_h100.drivers import (
    memory_peak,
    program_config,
    reference_precision,
    release,
    seeded_weights,
    shapes,
)
from bench_h100.reference import pix2pix, satclip as ref_satclip, scene as ref_scene
from bench_h100.reference import serve as ref_serve
from bench_h100.timing import Spans, synchronize

PLANE_STEP = 19  # the location plane is compared on every 19th row and column


class Session:
    """The program's scene serving for one seed."""

    def __init__(self, cell, seed: int, device):
        from nirgan_tpu_torch.models.satclip.location_encoder import LocationEncoder
        from nirgan_tpu_torch.tasks.px2px import Px2PxTask

        self.device = torch.device(device)
        s = cell.settings
        self.tile, self.overlap, self.batch = int(s["tile"]), int(s["overlap"]), int(s["batch"])
        self.task = Px2PxTask(program_config(cell), device=self.device, seed=seed)
        self.task.bind(seeded_weights(cell, seed, self.device)[0])
        self.tower = ref_satclip.siren_weights(weights.subseed(seed, 5), self.device)
        self.task.satclip_model.encoder = LocationEncoder(self.tower, legendre_polys=10)
        self.data = traffic_mod.Scene(cell.traffic, weights.subseed(seed, 3), self.device)
        self.rng = np.random.default_rng(weights.subseed(seed, 4))
        self.kept, self.seen, self.done = None, 0, 0
        self.taps = self.kept_taps = None
        self._tap(self.task, self.task.netG)
        _, h, w = self.data.rgb.shape
        self.windows = len(ref_scene.windows(h, w, self.tile, self.overlap))

    def _tap(self, task, net) -> None:
        """Record, while ``self.taps`` is set, the embeddings each window
        batch gives the generator and a sample of the plane made of them."""
        g_apply, plane = task.g_apply, net.location_plane

        def g_apply_tapped(rgb, embeds=None, *args, **kwargs):
            if self.taps is not None and embeds is not None:
                self.taps["embeds"].append(embeds.detach().to(torch.float32, copy=True))
            return g_apply(rgb, embeds, *args, **kwargs)

        def plane_tapped(embeds, height, width):
            out = plane(embeds, height, width)
            if self.taps is not None:
                self.taps["plane"].append(
                    out[:, ::PLANE_STEP, ::PLANE_STEP, 0].detach().to(torch.float32, copy=True))
            return out

        task.g_apply, net.location_plane = g_apply_tapped, plane_tapped

    def one(self, spans: Spans, keep: bool) -> None:
        """One whole scene, to the host."""
        from nirgan_tpu_torch.inference.scene import blend_scene, upload_scene

        rgb, meta = self.data.rgb, self.data.meta
        taps = self.taps = {"embeds": [], "plane": []} if keep else None
        with spans("upload_scene"):
            padded = upload_scene(self.task, rgb, self.tile, self.overlap)
        with spans("blend_scene"):
            nir, _ = blend_scene(self.task, padded, rgb.shape[1], rgb.shape[2],
                                 tile=self.tile, overlap=self.overlap,
                                 batch_size=self.batch, meta=meta)
            del padded
        with spans("to_host"):
            out = nir.cpu().numpy()
        self.taps = None
        self.done += self.windows
        if keep:  # a reservoir of one scene; each pass returns a new array
            self.seen += 1
            if self.rng.integers(0, self.seen) == 0:
                self.kept, self.kept_taps = out[0], taps

    def close(self) -> None:
        self.task = None
        release(self.device)


def judge(cell, seed: int, session: Session, device) -> dict:
    want = reference(cell, seed, session.data, session.tower, device)
    return {"rel_rmse": ref_serve.worst_rel_rmse(session.kept[None], want[None]),
            **tap_gaps(session.kept_taps,
                       reference_taps(cell, seed, session.data, session.tower, device))}


def reference_taps(cell, seed: int, data, tower: list, device,
                   arith=pix2pix.PLAIN, tower_dtype=np.float64) -> dict:
    """The reference's embeddings of every window (its tower in
    ``tower_dtype``) and its plane's sample (``arith`` on the dense layer),
    as ``Session`` records the program's."""
    s = cell.settings
    tile, overlap = int(s["tile"]), int(s["overlap"])
    _, h, w = data.rgb.shape
    e = torch.from_numpy(ref_scene.window_embeddings(
        data.meta, h, w, tower, tile, overlap, tower_dtype)).to(device)
    side = tile + 2 * pix2pix.pad_amount(cell.config)
    n = (side - 1) // 2 + 1  # the map after c0 (same size) and d0 (k3, s2, p1)
    wg = seeded_weights(cell, seed, device)[0]
    with reference_precision(), torch.no_grad():
        plane = pix2pix.location_plane(wg, e, n, n, arith)[:, 0, ::PLANE_STEP, ::PLANE_STEP]
    return {"embeds": e, "plane": plane}


def tap_gaps(got: dict, want: dict) -> dict:
    """``embed_gap`` and ``plane_gap`` of recorded taps (lists of tensors a
    window batch) against the reference's; a tap that recorded nothing, or
    not one row a window, reads as zeros (nothing given, nothing applied)."""
    out = {}
    for key, name in (("embeds", "embed_gap"), ("plane", "plane_gap")):
        r = want[key].double()
        parts = got[key] if got is not None else []
        g = torch.cat(parts).to(r) if parts else None
        if g is None or g.shape != r.shape:
            g = torch.zeros_like(r)
        if key == "embeds":
            out[name] = float((g - r).abs().max() / r.abs().max())
        else:
            out[name] = float((g - r).square().mean().sqrt() / r.square().mean().sqrt())
    return out


def reference(cell, seed: int, data, tower: list, device,
              arith=pix2pix.PLAIN) -> np.ndarray:
    """The reference's scene from the seeded weights and ``tower``."""
    s = cell.settings
    wg = seeded_weights(cell, seed, device)[0]
    with reference_precision():
        return ref_scene.scene(wg, data.rgb, data.meta, cell.config, tower,
                               int(s["tile"]), int(s["overlap"]), arith, device,
                               int(s.get("reference_chunk", 4)))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> core.Run:
    device = torch.device(device)
    s = cell.settings
    marks = [("imports", time.perf_counter() - t_start)]
    sess = Session(cell, seed, device)
    marks.append(("session", time.perf_counter() - t_start))
    idle = Spans(on=False)
    for _ in range(int(s["warmup_scenes"])):
        sess.one(idle, False)
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))

    spans = Spans()
    sess.done, n = 0, 0
    t0 = time.perf_counter()
    while True:
        sess.one(spans, True)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(device)
    window_s = time.perf_counter() - t0
    windows = sess.done

    dtrace = None
    if trace:
        k = int(s["trace_scenes"])
        annotated = Spans(annotate=True)

        def traced() -> int:
            for _ in range(k):
                sess.one(annotated, False)
            return k

        dtrace = trace_mod.profile(traced, device)
    peak = memory_peak(device)
    sess.close()

    got = judge(cell, seed, sess, device)
    checks = {k: (got[k], limit) for k, limit in cell.limits.items()}
    return core.Run(
        end_to_end={"scene_windows_per_s": windows / window_s, "setup_s": setup_s},
        window_s=window_s, units=n, work=windows, attempted=n * sess.windows,
        failed=n * sess.windows - windows, memory_peak_bytes=peak, checks=checks,
        spans=spans.totals, trace=dtrace, marks=marks,
        shapes=shapes(cell, sess.batch, sess.tile))
