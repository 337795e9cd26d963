"""The serving half of the conditional-GAN task, counterpart of
``Px2PxTask`` in ``nirgan_tpu/tasks/px2px.py`` (``:66-208``, ``:433-452``,
``:517-557``; reference ``model/pix2pix.py``).

Construction from the reference-schema config (plain generator route; the
SatCLIP routes are not ported yet), the padded generator apply, the DN to
reflectance scaling, the shape buckets and the NCHW ``predict_step``.
Training lives in the JAX package until the train step is ported.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from nirgan_tpu_torch.config import ConfigNode, tpu_section
from nirgan_tpu_torch.models import define_G
from nirgan_tpu_torch.models.layers import dtype_of
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad_to

__all__ = ["Px2PxTask"]


class Px2PxTask:
    def __init__(self, config: ConfigNode, device="cpu", seed: int = 0):
        """Build the generator on ``device`` with weights drawn from
        ``seed`` (bind a state_dict to serve trained weights)."""
        self.config = config
        self.opt = config.base_configs
        self.device = torch.device(device)
        tpu = tpu_section(config)
        self.compute_dtype = dtype_of(tpu.compute_dtype)
        self.dn_scale = float(config.Data.get("dn_scale", 10000.0))
        self.shape_buckets = sorted(int(b) for b in tpu.shape_buckets)
        if str(tpu.get("serving_quant", "none")) != "none":
            raise NotImplementedError("tpu.serving_quant: the int8 serving "
                                      "trunk is not ported yet")
        sc = config.get("satclip", ConfigNode({"use_satclip": False}))
        self.satclip = bool(sc.get("use_satclip", False))
        if self.satclip:
            raise NotImplementedError("the SatCLIP routes (concat, inject) "
                                      "are not ported yet")
        self.netG = define_G(
            self.opt.input_nc, self.opt.output_nc, self.opt.ngf,
            self.opt.netG, self.opt.norm, not self.opt.no_dropout,
            self.opt.init_type, self.opt.init_gain,
            compute_dtype=self.compute_dtype,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.netG.eval()
        # reflect-pad against edge artifacts (reference model/pix2pix.py:91-108)
        self.use_padding = bool(config.Data.padding)
        self.pad_amount = int(config.Data.padding_amount) if self.use_padding else 0

    # ------------------------------------------------------------- applies
    def g_apply(self, rgb: torch.Tensor) -> torch.Tensor:
        """Reflect-pad -> generator -> crop on NHWC reflectance (reference
        forward, ``model/pix2pix.py:88-110``)."""
        p = self.pad_amount
        x = reflect_pad2d(rgb, p) if self.use_padding else rgb
        pred = self.netG(x)
        if self.use_padding:
            pred = pred[:, p:-p, p:-p, :]
        return pred

    def _dn_to_reflectance(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """DN -> reflectance (x / dn_scale) for integer inputs; floats are
        already reflectance and only change dtype.  True division by a
        tensor on x's device, as the JAX op divides (a CPU scalar divisor
        would become a multiplication by its reciprocal on a card)."""
        if x.dtype.is_floating_point:
            return x.to(dtype)
        scale = torch.tensor(self.dn_scale, dtype=torch.float32, device=x.device)
        return (x.to(torch.float32) / scale).to(dtype)

    def bucket_for(self, h: int, w: int) -> int:
        """Smallest static bucket covering (h, w); grows in bucket-sized
        steps beyond the largest configured bucket."""
        m = max(h, w)
        for b in self.shape_buckets:
            if m <= b:
                return b
        top = self.shape_buckets[-1]
        return ((m + top - 1) // top) * top

    @torch.inference_mode()
    def predict_step(self, rgb, coords: Optional[np.ndarray] = None) -> np.ndarray:
        """Public inference API (reference ``predict_step``,
        ``model/pix2pix.py:133-163``): (B, 3, H, W) RGB reflectance ->
        (B, 1, H, W) NIR as f32 numpy.  The input is reflect-padded to its
        shape bucket, as the JAX task does for its static shapes, which
        changes the instance-norm statistics; the result is cropped back."""
        if coords is not None:
            raise NotImplementedError("coords serve the SatCLIP routes, "
                                      "which are not ported yet")
        rgb = np.asarray(rgb, np.float32)
        _, _, h, w = rgb.shape
        x = torch.from_numpy(rgb).to(self.device).permute(0, 2, 3, 1)
        size = self.bucket_for(h, w)
        x = reflect_pad_to(x, size, size)
        pred = self.g_apply(x.to(self.compute_dtype)).float()
        return pred[:, :h, :w, :].permute(0, 3, 1, 2).cpu().numpy()

    def bind(self, state_dict: Mapping[str, torch.Tensor]) -> "Px2PxTask":
        """Load generator weights (the port's state_dict names, as
        ``weights.params_from_jax`` or ``weights.load_reference_ckpt``
        give them) for serving."""
        self.netG.load_state_dict(state_dict, strict=True)
        return self
