"""Ahead-of-time export of the serving forward (``torch.export``),
counterpart of ``nirgan_tpu/inference/export.py``.

The RGB -> NIR predict program (reflect-pad, generator, crop; the plain,
inject and concat routes, and the int8 trunk) is traced once with fake
tensors into an ``ExportedProgram`` and serialised to bytes.  A serving
host loads and runs it with ``nirgan_tpu_torch.ops`` imported, which
registers the kernels' operators (``torch.ops.nirgan.*``), and nothing else
of the port: no model, task or config code.  The artifact fixes the input
shapes and dtypes and the device it was exported for; the generator's
parameters (its state_dict), and with the int8 trunk its pack, stay
runtime arguments, so checkpoint rotation and recalibration do not
re-export.

Constants of the trace (the inject plane's resize matrices) live on the
export's device, so an artifact runs on that device only: a call with
tensors elsewhere raises.  Kernel A's and C's weights are laid out for the
kernels once and kept while the weights are unchanged (``ops/_pack.py``
``laid_out``, keyed by the tensor and its version counter):
``Exported.call`` hands the kernels the tensors it was first given for as
long as a call's parameters are the same storage, so a state_dict made anew
for each call (``state_dict()`` detaches each parameter again, sharing its
storage and version counter) keeps the layout too, and an in-place write to
a parameter still makes it anew.  Tensors made under
``torch.inference_mode`` carry no version and are laid out on every call.
"""

from __future__ import annotations

import io
import json
from typing import Mapping, Optional

import numpy as np
import torch

import nirgan_tpu_torch.ops  # noqa: F401  (registers torch.ops.nirgan.*)

__all__ = ["export_generator", "load_exported", "run_exported"]

# the artifact's own facts, stored beside the program
_META = "nirgan_export.json"
EMBED_DIM = 256


class _Predict(torch.nn.Module):
    """The exported function: rgb (B, 3, H, W) f32 NCHW, embeds (B, 256)
    (read on the inject route only) [, the int8 pack] -> (B, 1, H, W) f32
    NCHW, computed in the task's compute dtype by ``g_apply(...,
    train=False)``.  The generator is a submodule, so its parameters are the
    program's, named ``netG.<state_dict key>``."""

    def __init__(self, task):
        super().__init__()
        self.netG = task.netG
        self._g_apply = task.g_apply
        self._dtype = task.compute_dtype
        self._inject = task.inject

    def forward(self, rgb_nchw, embeds, trunk_q=None):
        x = rgb_nchw.permute(0, 2, 3, 1).to(self._dtype)
        pred = self._g_apply(x, embeds if self._inject else None, trunk_q, train=False)
        return pred.float().permute(0, 3, 1, 2).contiguous()


def _template_matches(params_g: Mapping[str, torch.Tensor], netG) -> None:
    own = netG.state_dict()
    if set(params_g) != set(own):
        raise ValueError(f"export_generator: params_g has keys {sorted(set(params_g) ^ set(own))} "
                         "that the generator has not, or lacks ones it has")
    for k, v in own.items():
        p = params_g[k]
        if tuple(p.shape) != tuple(v.shape) or p.dtype != v.dtype:
            raise ValueError(f"export_generator: {k} is {p.dtype} {tuple(p.shape)}, the "
                             f"generator's {v.dtype} {tuple(v.shape)}")


def export_generator(task, params_g: Mapping[str, torch.Tensor], image_size: int,
                     batch_size: int, device=None, trunk_q: Optional[dict] = None) -> bytes:
    """Serialise the predict program for (B, 3, H, W) float32 NCHW inputs
    (the universal host contract) at a fixed shape.

    ``task``: a ``Px2PxTask``; ``params_g``: its generator's state_dict, the
    template of the parameters the program takes at run time (keys, shapes
    and dtypes must be the generator's).  ``device``: the device the
    artifact runs on, the task's (the card unless the task was built on the
    CPU); another raises.  ``trunk_q``: an int8 trunk pack
    (``task.build_trunk_q``) exports the int8 serving program instead; the
    pack becomes a fourth runtime argument.  Returns the artifact's bytes.
    """
    device = task.device if device is None else torch.device(device)
    if device != task.device:
        raise ValueError(f"export_generator: the task's generator lives on {task.device}, "
                         f"not {device}: build the task on the device to export for")
    _template_matches(params_g, task.netG)
    args = (torch.zeros((batch_size, 3, image_size, image_size), device=device),
            torch.zeros((batch_size, EMBED_DIM), device=device))
    if trunk_q is not None:
        args += (trunk_q,)
    with torch.no_grad():
        program = torch.export.export(_Predict(task), args, strict=False)
    meta = {"device": str(device), "int8": trunk_q is not None}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


class Exported:
    """A loaded artifact (``load_exported``).  ``call(params_g, rgb,
    embeds[, trunk_q])`` runs it under ``torch.no_grad`` on the device it
    was exported for; ``program`` is the ``ExportedProgram``."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.device = torch.device(meta["device"])
        self.int8 = bool(meta["int8"])
        self._module = program.module()
        self._kept: dict = {}  # state_dict key -> the tensor first given for it

    def _check_device(self, t: torch.Tensor, what: str) -> None:
        if t.device.type != self.device.type or (
                self.device.index is not None and t.device.index != self.device.index):
            raise ValueError(f"the artifact was exported for {self.device}; {what} is on "
                             f"{t.device} (export again on that device)")

    def _params(self, params_g: Mapping[str, torch.Tensor]) -> dict:
        """``netG.<key>`` -> tensor, each the one first given for its key
        while it is the same storage (kernel A's and C's kept layouts are
        keyed by the tensor; its version counter tells them of a write)."""
        out = {}
        for k, v in params_g.items():
            self._check_device(v, f"parameter {k}")
            kept = self._kept.get(k)
            if (kept is not None and not v.is_inference() and not kept.is_inference()
                    and kept.data_ptr() == v.data_ptr() and kept._version == v._version
                    and kept.shape == v.shape and kept.dtype == v.dtype
                    and kept.device == v.device):
                v = kept
            else:
                self._kept[k] = v
            out[f"netG.{k}"] = v
        return out

    def call(self, params_g: Mapping[str, torch.Tensor], rgb_nchw: torch.Tensor,
             embeds: torch.Tensor, trunk_q: Optional[dict] = None) -> torch.Tensor:
        if (trunk_q is not None) != self.int8:
            raise ValueError("the artifact was exported " + ("with" if self.int8 else "without")
                             + " an int8 trunk pack: pass trunk_q exactly then")
        self._check_device(rgb_nchw, "rgb")
        self._check_device(embeds, "embeds")
        args = (rgb_nchw, embeds) + ((trunk_q,) if trunk_q is not None else ())
        with torch.no_grad():
            return torch.func.functional_call(self._module, self._params(params_g), args)


def load_exported(blob: bytes) -> Exported:
    """bytes -> the loaded artifact (``Exported``; its ``call(params_g, rgb,
    embeds[, trunk_q])`` runs it)."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return Exported(program, json.loads(extra[_META]))


def run_exported(blob_or_exported, params_g: Mapping[str, torch.Tensor], rgb_nchw,
                 embeds=None, trunk_q: Optional[dict] = None) -> torch.Tensor:
    """Run a serialised or loaded artifact: (B, 1, H, W) f32 NCHW on the
    artifact's device.  ``rgb_nchw`` and ``embeds`` are tensors on that
    device, or host arrays, which are copied there.  ``embeds`` may be None
    for non-inject models (a zero placeholder is fed; the traced graph
    ignores it).  ``trunk_q`` is required iff the artifact was exported
    with one."""
    exported = (blob_or_exported if isinstance(blob_or_exported, Exported)
                else load_exported(blob_or_exported))

    def tensor(a):
        if isinstance(a, np.ndarray):
            return torch.as_tensor(a, dtype=torch.float32, device=exported.device)
        return a

    rgb = tensor(rgb_nchw)
    if embeds is None:
        embeds = torch.zeros((rgb.shape[0], EMBED_DIM), device=rgb.device)
    return exported.call(params_g, rgb, tensor(embeds), trunk_q)
