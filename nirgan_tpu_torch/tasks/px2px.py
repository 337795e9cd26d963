"""The conditional-GAN task, counterpart of ``Px2PxTask`` in
``nirgan_tpu/tasks/px2px.py`` (reference ``model/pix2pix.py``).

Construction from the reference-schema config (the plain generator and the
two SatCLIP routes: ``inject``, where the location embedding enters the
generator after ``nd0``, and ``concat``, where it becomes a 4th input
channel), the padded generator apply, the DN to reflectance scaling, the
shape buckets and the NCHW ``predict_step`` serve; ``extract_batch``,
``init_state``, ``train_step`` and ``eval_step`` train.  The frozen SatCLIP
tower runs in float64 on the host, once a batch, as the JAX package runs it
(a few hundred operations on (B,) vectors: launches would cost a card more
than the arithmetic costs the host).  ``embed_coords`` is that host part on
its own: the trainer and the bulk synthesis hand it to their loaders, whose
producer thread then runs the tower while the device works on the batch
before, and ``extract_batch`` only copies the (B, 256) f32 embeddings with
the batch's other tensors.  A batch that comes without "embeds" gets them
where it is extracted.

``train_step`` keeps the JAX package's fused semantics (``px2px.py:256-365``):
one generator forward whose graph is kept, the discriminator update on the
detached prediction (fake, then real), then the generator loss through the
*updated* discriminator, which takes no gradient from it.  Loss algebra
(``model/pix2pix.py:195-257``):

  D:  gan(fake, 0) + gan(real, 1)            (x0.5 only with
                                              ``legacy_halve_d_loss``)
  G:  lambda_GAN * gan(fake, 1) + lambda_L1 * L1
      [+ lambda_ssim * (1 - SSIM) + lambda_hist * EMD
       + lambda_rs_losses * weighted spectral-index loss]

The three auxiliary terms join only where their lambda is > 0, each under
its ``model_loss/*`` key, as ``g_loss_on_pred`` adds them
(``nirgan_tpu/tasks/px2px.py:312-326``).

Batch-norm nets (``norm: batch``) and dropout (``no_dropout: false``) train
as the JAX step runs them: the generator's one forward in training mode
updates its running statistics once and draws its dropout from the train
state's generator; the discriminator runs in training mode all three
times, so its statistics move three times in JAX's order (fake, real, then
the G loss's fake through the updated D).  Everything that serves
(``eval_step``, ``predict_step``, ``g_apply`` by default, and with it the
bulk and the scene serving) runs the generator in eval mode: the running
averages normalise, the dropout is off.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Mapping, Optional

import numpy as np
import torch

from nirgan_tpu_torch.config import ConfigNode, tpu_section
from nirgan_tpu_torch.data.pipeline import DeviceStager
from nirgan_tpu_torch.losses import (
    RemoteSensingIndices,
    calculate_metrics,
    emd_loss,
    gan_loss,
    l1_loss,
    ssim_loss,
)
from nirgan_tpu_torch.models import define_D, define_G, define_G_inject
from nirgan_tpu_torch.models.layers import dtype_of, set_dropout_generator
from nirgan_tpu_torch.ops.int8_trunk import CALIB_ROWS, calibrate_trunk, quantize_trunk
from nirgan_tpu_torch.ops.pad import reflect_pad2d, reflect_pad_to
from nirgan_tpu_torch.ops.resize import resize_bicubic
from nirgan_tpu_torch.train.state import (
    TrainState,
    adam_for,
    cast_params,
    check_finite,
    param_dtype_of,
)

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


def _set_mode(module: torch.nn.Module, train: bool) -> None:
    """Training or eval mode, switched only where it changes."""
    if module.training != train:
        module.train(train)


def _requires_grad(module: torch.nn.Module, flag: bool) -> None:
    for p in module.parameters():
        p.requires_grad_(flag)


@contextlib.contextmanager
def _cudnn_deterministic(on: bool):
    """cuDNN's deterministic algorithms while the block runs, where ``on``;
    the setting before it comes back after.  Only this flag changes:
    ``torch.backends.cudnn.flags`` would also set TF32 and benchmarking to
    its own defaults for the block."""
    if not on:
        yield
        return
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class Px2PxTask:
    def __init__(self, config: ConfigNode, device="cuda", seed: int = 0):
        """Build the generator and the discriminator on ``device`` (the
        card unless the caller asks for the CPU) with weights drawn from
        ``seed``, G first (bind a state_dict to serve trained weights)."""
        self.config = config
        self.opt = config.base_configs
        self.device = torch.device(device)
        self.seed = int(seed)
        # host arrays reach the device, and results come back, through
        # pinned buffers and a copy stream of their own
        self.stager = DeviceStager(self.device)
        tpu = tpu_section(config)
        # G's and D's parameters (and Adam's moments) in tpu.param_dtype
        self.param_dtype = param_dtype_of(tpu)
        self.compute_dtype = dtype_of(tpu.compute_dtype)
        # float rgb / nir cast on the host to this dtype before their copy
        # (e.g. "float16"), widened on the device by the step: the JAX task
        # casts them in extract_batch alone
        td = tpu.get("transfer_dtype", None)
        self.transfer_dtype = np.dtype(td) if td else None
        # raise on the first non-finite loss or gradient of a train step
        # (the JAX trainer's jax_debug_nans)
        self.debug_nans = bool(tpu.get("debug_nans", False))
        self.dn_scale = float(config.Data.get("dn_scale", 10000.0))
        self.shape_buckets = sorted(int(b) for b in tpu.shape_buckets)
        # train metrics every 10th step, as the reference (pix2pix.py:183)
        self.train_metrics_every = int(tpu.get("train_metrics_every", 10))
        # "int8" serves the residual trunk in int8 (ops/int8_trunk.py,
        # kernels D and E), calibrated on the first batch served
        self.serving_quant = str(tpu.get("serving_quant", "none"))
        self._trunk_q, self._trunk_q_of = None, None
        sc = config.get("satclip", ConfigNode({"use_satclip": False}))
        self.satclip = bool(sc.get("use_satclip", False))
        self.satclip_style = sc.get("satclip_style", None) if self.satclip else None
        if self.satclip and self.satclip_style not in ("concat", "inject"):
            raise NotImplementedError("SatClip Style not recognized, choose "
                                      "'concat' or 'inject'")
        self.inject = self.satclip_style == "inject"
        netG, netD = self._networks(seed)
        self.netG, self.netD = netG.to(self.device), netD.to(self.device)

        # the frozen SatCLIP tower, float64 on the host
        self.satclip_model = None
        if self.satclip:
            from nirgan_tpu_torch.models.satclip import SatClipWrapper

            self.satclip_model = SatClipWrapper(sc.get("satclip_path", None))
        self.satclip_scaling_factor = (float(sc.get("scaling_factor", 1.0))
                                       if self.satclip else 1.0)

        self.gan_mode = self.opt.gan_mode
        self.lambda_gan = float(self.opt.lambda_GAN)
        self.lambda_l1 = float(self.opt.lambda_L1)
        self.lambda_ssim = float(self.opt.get("lambda_ssim", 0.0))
        self.lambda_hist = float(self.opt.get("lambda_hist", 0.0))
        self.lambda_rs = float(self.opt.get("lambda_rs_losses", 0.0))
        self.rs_losses = (
            RemoteSensingIndices(mode="loss", criterion=self.opt.rs_losses_criterium)
            if self.lambda_rs > 0.0 else None)
        self.rs_weights = (dict(self.opt.internal_rs_loss_weights)
                           if "internal_rs_loss_weights" in self.opt else None)
        if self.gan_mode not in ("lsgan", "vanilla", "wgangp"):
            raise NotImplementedError(f"gan mode {self.gan_mode} not implemented")
        # legacy Pix2PixModel halves the D loss; the PL port does not
        self.legacy_halve_d_loss = bool(self.opt.get("legacy_halve_d_loss", False))

        # batch-norm nets carry running statistics; dropout needs a random
        # stream (the train state's generator)
        self.has_bn = self.opt.get("norm", "instance") == "batch"
        self.uses_dropout = not self.opt.get("no_dropout", True)
        if self.serving_quant == "int8" and not self.wants_int8_serving():
            warnings.warn(
                "tpu.serving_quant: int8 ignored - the mode needs a resnet "
                "generator with affine-free instance norm and no dropout "
                "(ops/int8_trunk.py); serving will run the float path.")

        # reflect-pad against edge artifacts (reference model/pix2pix.py:91-108)
        self.use_padding = bool(config.Data.padding)
        self.pad_amount = int(config.Data.padding_amount) if self.use_padding else 0

    def _networks(self, seed: int):
        """The generator and the discriminator on the host, drawn from one
        generator seeded with ``seed``, G first, their parameters in
        ``tpu.param_dtype``."""
        concat = self.satclip_style == "concat"
        gen = torch.Generator().manual_seed(seed)
        # generator selection (reference model/pix2pix.py:27-53)
        if self.inject:
            netG = define_G_inject(self.config, compute_dtype=self.compute_dtype,
                                   generator=gen)
        else:
            netG = define_G(
                self.opt.input_nc + int(concat), self.opt.output_nc,
                self.opt.ngf, self.opt.netG, self.opt.norm,
                not self.opt.no_dropout, self.opt.init_type,
                self.opt.init_gain, compute_dtype=self.compute_dtype,
                generator=gen)
        # D is sized from its true input, G's input channels + the output:
        # the concat route's conditioning has 4 channels (the reference
        # hard-codes input_nc + output_nc, which breaks its own concat style)
        netD = define_D(
            self.opt.input_nc + int(concat) + self.opt.output_nc,
            self.opt.ndf, self.opt.netD, self.opt.n_layers_D, self.opt.norm,
            self.opt.init_type, self.opt.init_gain,
            compute_dtype=self.compute_dtype, generator=gen)
        return cast_params(netG, self.param_dtype), cast_params(netD, self.param_dtype)

    # ------------------------------------------------------------- applies
    def g_apply(self, rgb: torch.Tensor, embeds: Optional[torch.Tensor] = None,
                trunk_q: Optional[dict] = None, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Reflect-pad -> generator -> crop on NHWC reflectance (reference
        forward, ``model/pix2pix.py:88-110``); ``embeds`` (B, E) feed the
        inject route only; ``trunk_q`` runs the trunk in int8 (serving).
        ``train`` runs the generator in training mode (its batch norms
        update their running statistics, its dropout draws from ``rng``);
        else in eval mode."""
        _set_mode(self.netG, train)
        if train:
            set_dropout_generator(self.netG, rng)
        p = self.pad_amount
        x = reflect_pad2d(rgb, p) if self.use_padding else rgb
        pred = self.netG(x, embeds if self.inject else None, trunk_q=trunk_q)
        if self.use_padding:
            pred = pred[:, p:-p, p:-p, :]
        return pred

    def _dn_to_reflectance(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """DN -> reflectance (x / dn_scale) for integer inputs; floats are
        already reflectance and only change dtype.  True division by a
        tensor on x's device, as the JAX op divides (a CPU scalar divisor
        would become a multiplication by its reciprocal on a card); the
        divisor is filled on the device, since a ``torch.tensor`` made from
        the host would wait for the compute stream to drain."""
        if x.dtype.is_floating_point:
            return x.to(dtype)
        scale = torch.full((), self.dn_scale, dtype=torch.float32, device=x.device)
        return (x.to(torch.float32) / scale).to(dtype)

    # ---------------------------------------------------------------- train
    def extract_batch(self, batch: Mapping) -> dict:
        """Reference data contract in, NHWC step batch on the task's device
        out (``nirgan_tpu/tasks/px2px.py:406-452``): {"rgb": (B, 3, H, W),
        "nir": (B, 1, H, W) [, "coords": (B, 2) lon/lat]} as numpy.
        uint8/uint16 DN stay integer through the copy and are divided by
        ``dn_scale`` on the device by the step; anything else is copied as
        f32.  The SatCLIP routes need ``coords``: inject adds "embeds"
        (B, E) f32; concat converts DN to f32 reflectance here, since the
        embedding plane joins as a float 4th channel of "rgb".  On a card
        the arrays go through the task's ``DeviceStager``: pinned buffers,
        a copy stream, and the compute stream waits on the batch's event,
        so the host does not wait for the device."""
        embeds = batch.get("embeds")
        if self.satclip and embeds is None:
            embeds = self._embed(batch.get("coords"))
        arrays = [self._for_transfer(batch["rgb"]), self._for_transfer(batch["nir"])]
        if self.satclip:
            arrays.append(np.asarray(embeds, np.float32))
        staged = self._ingest(*arrays)
        out = {"rgb": staged[0], "nir": staged[1]}
        if self.satclip:
            out.update(self.condition(out["rgb"], None, staged[2]))
        return out

    def embed_coords(self, batch: Mapping) -> Mapping:
        """The host's part of the SatCLIP conditioning, for a loader's
        thread: ``batch`` with "embeds" (B, E) f32 on the host, from its
        "coords" through the frozen tower.  The plain route's batches pass
        unchanged."""
        if not self.satclip or "embeds" in batch:
            return batch
        return {**batch, "embeds": self._embed(batch["coords"])}

    def _embed(self, coords) -> torch.Tensor:
        """(B, 2) coords, taken as f32 degrees as the JAX task takes them,
        through the tower."""
        return self.satclip_model.embed(np.asarray(coords, np.float32))

    def _for_transfer(self, x) -> np.ndarray:
        """A float batch array cast to ``tpu.transfer_dtype`` on the host
        (the JAX task's ``_ingest``); DN integers and, without the key,
        every array as it is."""
        x = np.asarray(x)
        if self.transfer_dtype is None or x.dtype in (np.uint8, np.uint16):
            return x
        return np.asarray(x, self.transfer_dtype)

    def _ingest(self, *arrays) -> list:
        """Host arrays -> tensors on the task's device, in one staged copy:
        each 4-d NCHW array becomes an NHWC view; uint8/uint16 DN and arrays
        already in the transfer dtype pass through, everything else becomes
        f32."""
        keep = (np.uint8, np.uint16) + ((self.transfer_dtype,) if self.transfer_dtype
                                        else ())
        host = []
        for x in arrays:
            x = np.asarray(x)
            host.append(x if x.dtype in keep else np.asarray(x, np.float32))
        return [t.permute(0, 2, 3, 1) if t.dim() == 4 else t
                for t in self.stager.to_device(host)]

    def condition(self, rgb: torch.Tensor, coords, embeds=None) -> dict:
        """The SatCLIP routes' part of a step batch from the NHWC ``rgb`` on
        the device and either (B, 2) ``coords`` or the ``embeds`` that
        ``embed_coords`` made of them: {"embeds"} for inject, {"rgb"} with
        the plane attached for concat."""
        if embeds is None:
            embeds = self._embed(coords)
        if embeds.device.type != self.device.type:
            embeds = self._ingest(embeds.numpy())[0]
        if self.inject:
            return {"embeds": embeds}
        rgb = self._dn_to_reflectance(rgb, torch.float32)
        return {"rgb": self._concat_embedding_plane(rgb, embeds)}

    def _concat_embedding_plane(self, rgb: torch.Tensor,
                                embeds: torch.Tensor) -> torch.Tensor:
        """Embedding -> image plane -> 4th channel (reference
        ``satclip_get_concat``, ``model/pix2pix.py:466-476``): the 256-d
        vector is laid out along width, tiled over height, bicubically
        resized to (W, H), the reference's swapped-size call, and scaled."""
        b, h, w, _ = rgb.shape
        e = embeds.shape[-1]
        plane = embeds.reshape(b, 1, e, 1).expand(b, e, e, 1)
        plane = resize_bicubic(plane, w, h) * self.satclip_scaling_factor
        return torch.cat([rgb, plane.to(rgb.dtype)], dim=-1)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Adam for G and for D at ``base_configs.lr``, step 0, and the
        dropout's generator on the task's device, seeded with the task's
        seed.  A ``seed`` other than the one the task was built with draws
        both networks anew from it, in place (the JAX task's
        ``init_state(seed)`` makes its params from the seed)."""
        if seed is not None and int(seed) != self.seed:
            netG, netD = self._networks(int(seed))
            with torch.no_grad():
                self.netG.load_state_dict(netG.state_dict())
                self.netD.load_state_dict(netD.state_dict())
            self.seed, self._trunk_q = int(seed), None
        lr, beta1 = float(self.opt.lr), float(self.opt.beta1)
        rng = torch.Generator(device=self.device).manual_seed(self.seed)
        return TrainState(step=0, opt_g=adam_for(self.netG, lr, beta1),
                          opt_d=adam_for(self.netD, lr, beta1), rng=rng)

    def train_step(self, state: TrainState, batch: Mapping) -> dict:
        """One fused GAN step on an ``extract_batch`` batch; updates the
        networks, the optimizers and ``state.step`` in place and returns the
        8 ``model_loss/*`` terms (and each auxiliary term whose lambda is
        > 0) and the 4 ``train/*`` metrics as 0-d f32 tensors on the device (the metrics NaN except every
        ``train_metrics_every``-th step), and on the inject route the
        updated ``scale_param`` / ``post_correction_param``.  A float32 step
        on a card runs its convolutions on cuDNN's deterministic algorithms,
        so that it repeats bit for bit from a seed as the JAX step does (the
        bf16 step's algorithms repeat without it)."""
        with _cudnn_deterministic(self.compute_dtype == torch.float32
                                  and self.device.type == "cuda"):
            return self._fused_step(state, batch)

    def _fused_step(self, state: TrainState, batch: Mapping) -> dict:
        rgb = self._dn_to_reflectance(batch["rgb"], self.compute_dtype)
        nir = self._dn_to_reflectance(batch["nir"], torch.float32)

        # --- one generator forward, its graph kept for the G update
        pred = self.g_apply(rgb, batch.get("embeds"), train=True, rng=state.rng)
        pred_sg = pred.detach()
        # D in training mode for all three of its forwards
        _set_mode(self.netD, True)

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
        if self.debug_nans:
            check_finite("D", loss_d, self.netD)
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
        aux = {}
        if self.lambda_ssim > 0.0:
            aux["model_loss/generator_ssim"] = term = ssim_loss(pred, nir)
            loss_g = loss_g + term * self.lambda_ssim
        if self.lambda_hist > 0.0:
            aux["model_loss/generator_hist"] = term = emd_loss(pred, nir)
            loss_g = loss_g + term * self.lambda_hist
        if self.lambda_rs > 0.0:
            # the indices see the RGB only: the concat route's 4th channel
            # is the embedding plane
            aux["model_loss/indices_loss_weighted"] = term = (
                self.rs_losses.get_and_weight_losses(
                    rgb[..., :self.opt.input_nc], nir, pred,
                    loss_config=self.rs_weights))
            loss_g = loss_g + term * self.lambda_rs
        state.opt_g.zero_grad(set_to_none=True)
        loss_g.backward()
        if self.debug_nans:
            check_finite("G", loss_g, self.netG)
        state.opt_g.step()

        with torch.no_grad():
            terms = (logits_fake.float().mean(), logits_real.float().mean(),
                     loss_d_fake, loss_d_real, loss_d, loss_g_gan, loss_g_l1,
                     loss_g)
            metrics = {k: v.detach().float() for k, v in zip(LOSS_KEYS, terms)}
            metrics.update({k: v.detach().float() for k, v in aux.items()})
            if (state.step + 1) % max(self.train_metrics_every, 1) == 0:
                metrics.update(calculate_metrics(pred_sg, nir, phase="train"))
            else:
                nan = torch.full((), math.nan, device=nir.device)
                metrics.update({k: nan for k in METRIC_KEYS})
            # the learnable conditioning scalars (reference logs them,
            # pix2pix.py:188-192), as the update left them
            for name in ("scale_param", "post_correction_param"):
                p = getattr(self.netG, name, None)
                if p is not None:
                    metrics[name] = p.detach().float().clone()
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Mapping):
        """(prediction f32 NHWC, ``val/*`` metrics) on an ``extract_batch``
        batch; a ``_valid`` (B,) row mask drops padded rows."""
        rgb = self._dn_to_reflectance(batch["rgb"], self.compute_dtype)
        nir = self._dn_to_reflectance(batch["nir"], torch.float32)
        pred = self.g_apply(rgb, batch.get("embeds"))
        metrics = calculate_metrics(pred, nir, phase="val",
                                    mask=batch.get("_valid"))
        return pred.float(), metrics

    # ---------------------------------------------------- int8 serving trunk
    def wants_int8_serving(self) -> bool:
        """``serving_quant: int8`` on a config that can take it: a resnet
        generator with blocks, affine-free instance norm (the formulation
        normalises the int32 accumulator through it) and no dropout."""
        return (self.serving_quant == "int8"
                and getattr(self.netG, "n_blocks", 0) > 0
                and self.opt.get("norm", "instance") == "instance"
                and not self.uses_dropout)

    def build_trunk_q(self, x: torch.Tensor, embeds: Optional[torch.Tensor] = None,
                      stage2: bool = False) -> dict:
        """Quantise the bound generator's residual trunk for serving
        (``nirgan_tpu/tasks/px2px.py:476-502``).  ``x``: a calibration input
        exactly as ``g_apply`` receives it (NHWC reflectance, the concat
        route's plane attached); its first 16 rows, reflect-padded by the
        task's pad, go through one float forward with hooks, then the
        weights are quantised per output channel.  ``stage2`` also
        quantises the d1 conv (``int8_d1_forward``); as in the JAX package
        it is off by default and no config key turns it on."""
        x = x[:CALIB_ROWS]
        xp = reflect_pad2d(x, self.pad_amount) if self.use_padding else x
        e = embeds[:CALIB_ROWS].to(self.device) if self.inject and embeds is not None else None
        with torch.no_grad():
            calib = calibrate_trunk(self.netG, xp.to(self.compute_dtype), e,
                                    stage2=stage2)
            # the pack outlives the inference-mode call that calibrates: its
            # tensors are made as normal ones, so kernel D keeps their layout
            with torch.inference_mode(False):
                return quantize_trunk(self.netG.state_dict(), self.netG.n_blocks,
                                      calib)

    def _weight_versions(self) -> tuple:
        """The generator's parameters' version counters, which every
        in-place write raises (an optimizer step, ``load_state_dict``)."""
        return tuple(p._version for p in self.netG.parameters())

    def trunk_q_for(self, x: torch.Tensor,
                    embeds: Optional[torch.Tensor] = None) -> Optional[dict]:
        """The int8 pack to serve with, or None on the float path: built
        from ``x`` (and ``embeds``) on the first call with the current
        weights, then kept as long as they are: a write to any of them
        (``bind``, a training step) drops it, and the next call calibrates
        anew (the JAX trainer re-binds before each validation sweep)."""
        if not self.wants_int8_serving():
            return None
        if self.kept_trunk_q() is None:
            self._trunk_q = self.build_trunk_q(x, embeds)
            self._trunk_q_of = self._weight_versions()
        return self._trunk_q

    def kept_trunk_q(self) -> Optional[dict]:
        """The int8 pack if it was built from the current weights, else
        None."""
        if self._trunk_q is not None and self._trunk_q_of == self._weight_versions():
            return self._trunk_q
        return None

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
        ``model/pix2pix.py:133-163``): (B, 3, H, W) RGB reflectance [and
        (B, 2) lon/lat ``coords`` on the SatCLIP routes] -> (B, 1, H, W)
        NIR as f32 numpy.  The input (with the concat route's plane
        attached) is reflect-padded to its shape bucket, as the JAX task
        does for its static shapes, which changes the instance-norm
        statistics; the result is cropped back.  With ``serving_quant:
        int8`` the first batch calibrates the int8 trunk, which then serves
        every batch until the weights change (``trunk_q_for``)."""
        rgb = np.asarray(rgb, np.float32)
        _, _, h, w = rgb.shape
        size = self.bucket_for(h, w)
        self.check_unet_side(size)
        cond = {"rgb": self._ingest(rgb)[0]}
        if self.satclip:
            if coords is None:
                raise ValueError("SatCLIP model requires coords (B, 2) for "
                                 "prediction")
            cond.update(self.condition(cond["rgb"], coords))
        x = reflect_pad_to(cond["rgb"], size, size).to(self.compute_dtype)
        trunk_q = self.trunk_q_for(x, cond.get("embeds"))
        pred = self.g_apply(x, cond.get("embeds"), trunk_q).float()
        return self.stager.to_host(pred[:, :h, :w, :].permute(0, 3, 1, 2)).result()

    def check_unet_side(self, side: int) -> None:
        """A U-Net's input side (the bucket plus twice the task's pad) must
        divide by 2^num_downs; the reference's torch U-Net fails alike under
        its reflect pad, so U-Nets serve with ``Data.padding: false``.
        Raises ValueError otherwise."""
        downs = getattr(self.netG, "num_downs", None)
        eff = side + 2 * self.pad_amount
        if downs is not None and eff % (1 << downs):
            raise ValueError(
                f"{self.opt.netG} needs (tile + 2 padding_amount) divisible by "
                f"{1 << downs}, got {eff}: serve U-Nets with Data.padding: "
                "false and a power-of-two tile")

    def load_torch_weights(self, path: str) -> dict:
        """Weights-only warm start from a reference Lightning ``.ckpt``
        (``train.py:61-65``): {"netG": ..., "netD": ...} state_dicts of
        whatever towers it has."""
        from nirgan_tpu_torch.weights import load_reference_weights

        return load_reference_weights(path, self.config)

    def bind(self, state_dict: Mapping[str, torch.Tensor]) -> "Px2PxTask":
        """Load generator weights (the port's state_dict names, as
        ``weights.params_from_jax`` or ``weights.load_reference_ckpt``
        give them) for serving; an int8 pack of the earlier weights is
        dropped and rebuilt on the next batch served."""
        self.netG.load_state_dict(state_dict, strict=True)
        self._trunk_q = None
        return self
