"""The conditional-GAN task, counterpart of ``Px2PxTask`` in
``nirgan_tpu/tasks/px2px.py`` (reference ``model/pix2pix.py``).

Construction from the reference-schema config (plain generator route; the
SatCLIP routes are not ported yet), the padded generator apply, the DN to
reflectance scaling, the shape buckets and the NCHW ``predict_step`` serve;
``extract_batch``, ``init_state``, ``train_step`` and ``eval_step`` train.

``train_step`` keeps the JAX package's fused semantics (``px2px.py:256-365``):
one generator forward whose graph is kept, the discriminator update on the
detached prediction (fake, then real), then the generator loss through the
*updated* discriminator, which takes no gradient from it.  Loss algebra
(``model/pix2pix.py:195-257``):

  D:  gan(fake, 0) + gan(real, 1)            (x0.5 only with
                                              ``legacy_halve_d_loss``)
  G:  lambda_GAN * gan(fake, 1) + lambda_L1 * L1
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from nirgan_tpu_torch.config import ConfigNode, tpu_section
from nirgan_tpu_torch.losses import calculate_metrics, gan_loss, l1_loss
from nirgan_tpu_torch.models import define_D, define_G
from nirgan_tpu_torch.models.layers import dtype_of
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad_to
from nirgan_tpu_torch.train.state import TrainState, adam_for

__all__ = ["Px2PxTask"]

# the loss terms train_step returns, in the JAX step's order
LOSS_KEYS = (
    "model_loss/discriminator_predFake",
    "model_loss/discriminator_predReal",
    "model_loss/discriminator_fake",
    "model_loss/discriminator_real",
    "model_loss/discriminator_loss",
    "model_loss/generator_GAN_loss",
    "model_loss/generator_L1",
    "model_loss/generator_total_loss",
)
METRIC_KEYS = ("train/L1", "train/L2", "train/PSNR", "train/SSIM")


def _requires_grad(module: torch.nn.Module, flag: bool) -> None:
    for p in module.parameters():
        p.requires_grad_(flag)


class Px2PxTask:
    def __init__(self, config: ConfigNode, device="cpu", seed: int = 0):
        """Build the generator and the discriminator on ``device`` with
        weights drawn from ``seed``, G first (bind a state_dict to serve
        trained weights)."""
        self.config = config
        self.opt = config.base_configs
        self.device = torch.device(device)
        tpu = tpu_section(config)
        self.compute_dtype = dtype_of(tpu.compute_dtype)
        self.dn_scale = float(config.Data.get("dn_scale", 10000.0))
        self.shape_buckets = sorted(int(b) for b in tpu.shape_buckets)
        # train metrics every 10th step, as the reference (pix2pix.py:183)
        self.train_metrics_every = int(tpu.get("train_metrics_every", 10))
        if str(tpu.get("serving_quant", "none")) != "none":
            raise NotImplementedError("tpu.serving_quant: the int8 serving "
                                      "trunk is not ported yet")
        sc = config.get("satclip", ConfigNode({"use_satclip": False}))
        self.satclip = bool(sc.get("use_satclip", False))
        if self.satclip:
            raise NotImplementedError("the SatCLIP routes (concat, inject) "
                                      "are not ported yet")
        gen = torch.Generator().manual_seed(seed)
        self.netG = define_G(
            self.opt.input_nc, self.opt.output_nc, self.opt.ngf,
            self.opt.netG, self.opt.norm, not self.opt.no_dropout,
            self.opt.init_type, self.opt.init_gain,
            compute_dtype=self.compute_dtype, generator=gen).to(self.device)
        self.netD = define_D(
            self.opt.input_nc + self.opt.output_nc, self.opt.ndf,
            self.opt.netD, self.opt.n_layers_D, self.opt.norm,
            self.opt.init_type, self.opt.init_gain,
            compute_dtype=self.compute_dtype, generator=gen).to(self.device)

        self.gan_mode = self.opt.gan_mode
        self.lambda_gan = float(self.opt.lambda_GAN)
        self.lambda_l1 = float(self.opt.lambda_L1)
        for key in ("lambda_ssim", "lambda_hist", "lambda_rs_losses"):
            if float(self.opt.get(key, 0.0)) > 0.0:
                raise NotImplementedError(f"base_configs.{key} > 0: the "
                                          "auxiliary losses are not ported yet")
        if self.gan_mode not in ("lsgan", "vanilla", "wgangp"):
            raise NotImplementedError(f"gan mode {self.gan_mode} not implemented")
        # legacy Pix2PixModel halves the D loss; the PL port does not
        self.legacy_halve_d_loss = bool(self.opt.get("legacy_halve_d_loss", False))

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

    # ---------------------------------------------------------------- train
    def extract_batch(self, batch: Mapping) -> dict:
        """Reference data contract in, NHWC step batch on the task's device
        out (``nirgan_tpu/tasks/px2px.py:406-452``): {"rgb": (B, 3, H, W),
        "nir": (B, 1, H, W)} as numpy.  uint8/uint16 DN stay integer through
        the copy and are divided by ``dn_scale`` on the device by the step;
        anything else is copied as f32."""
        out = {}
        for key in ("rgb", "nir"):
            x = np.asarray(batch[key])
            if x.dtype not in (np.uint8, np.uint16):
                x = np.asarray(x, np.float32)
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            out[key] = t.permute(0, 2, 3, 1)
        return out

    def init_state(self) -> TrainState:
        """Adam for G and for D at ``base_configs.lr``, step 0."""
        lr, beta1 = float(self.opt.lr), float(self.opt.beta1)
        return TrainState(step=0, opt_g=adam_for(self.netG, lr, beta1),
                          opt_d=adam_for(self.netD, lr, beta1))

    def train_step(self, state: TrainState, batch: Mapping) -> dict:
        """One fused GAN step on an ``extract_batch`` batch; updates the
        networks, the optimizers and ``state.step`` in place and returns the
        8 ``model_loss/*`` terms and the 4 ``train/*`` metrics as 0-d f32
        tensors on the device (the metrics NaN except every
        ``train_metrics_every``-th step)."""
        rgb = self._dn_to_reflectance(batch["rgb"], self.compute_dtype)
        nir = self._dn_to_reflectance(batch["nir"], torch.float32)

        # --- one generator forward, its graph kept for the G update
        pred = self.g_apply(rgb)
        pred_sg = pred.detach()

        # --- discriminator update (optimizer_idx 0; pix2pix.py:195-212)
        logits_fake = self.netD(torch.cat([rgb, pred_sg], dim=-1))
        logits_real = self.netD(torch.cat([rgb, nir.to(rgb.dtype)], dim=-1))
        loss_d_fake = gan_loss(logits_fake, False, self.gan_mode)
        loss_d_real = gan_loss(logits_real, True, self.gan_mode)
        loss_d = loss_d_fake + loss_d_real
        if self.legacy_halve_d_loss:
            loss_d = loss_d * 0.5
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        state.opt_d.step()

        # --- generator update through the updated D, which takes no
        #     gradient from it
        _requires_grad(self.netD, False)
        try:
            logits_g = self.netD(torch.cat([rgb, pred], dim=-1))
        finally:
            _requires_grad(self.netD, True)
        loss_g_gan = gan_loss(logits_g, True, self.gan_mode)
        loss_g_l1 = l1_loss(pred, nir)
        loss_g = loss_g_gan * self.lambda_gan + loss_g_l1 * self.lambda_l1
        state.opt_g.zero_grad(set_to_none=True)
        loss_g.backward()
        state.opt_g.step()

        with torch.no_grad():
            terms = (logits_fake.float().mean(), logits_real.float().mean(),
                     loss_d_fake, loss_d_real, loss_d, loss_g_gan, loss_g_l1,
                     loss_g)
            metrics = {k: v.detach().float() for k, v in zip(LOSS_KEYS, terms)}
            if (state.step + 1) % max(self.train_metrics_every, 1) == 0:
                metrics.update(calculate_metrics(pred_sg, nir, phase="train"))
            else:
                nan = torch.full((), math.nan, device=nir.device)
                metrics.update({k: nan for k in METRIC_KEYS})
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Mapping):
        """(prediction f32 NHWC, ``val/*`` metrics) on an ``extract_batch``
        batch; a ``_valid`` (B,) row mask drops padded rows."""
        rgb = self._dn_to_reflectance(batch["rgb"], self.compute_dtype)
        nir = self._dn_to_reflectance(batch["nir"], torch.float32)
        pred = self.g_apply(rgb)
        metrics = calculate_metrics(pred, nir, phase="val",
                                    mask=batch.get("_valid"))
        return pred.float(), metrics

    # ---------------------------------------------------------------- serve
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
