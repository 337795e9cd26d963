"""The baseline regression task, counterpart of
``nirgan_tpu/tasks/baseline.py`` (reference ``model/baseline_models.py``):
MSE-only training of ``Linear_NIR``, ``MLP_NIR`` or ``CNN_NIR`` with Adam
(torch's defaults, betas (0.9, 0.999)) at the live learning rate, the shared
data contract and the validation metrics.  It presents the trainer the
surface of ``Px2PxTask`` (``init_state``, ``extract_batch``,
``embed_coords``, ``train_step``, ``eval_step``, ``bind``,
``predict_step``, ``load_torch_weights``) with no discriminator: ``netD``
is None and the state has no ``opt_d``.

As in the JAX task, the batch's arrays become f32 on the host, DN or
reflectance alike (the baselines take no ``dn_scale``), every train step
returns its metrics, and serving applies the model to the tile as it is:
no pad, no bucket.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from nirgan_tpu_torch.config import ConfigNode, tpu_section
from nirgan_tpu_torch.data.pipeline import DeviceStager
from nirgan_tpu_torch.losses import calculate_metrics, mse_loss
from nirgan_tpu_torch.models.baselines import build_baseline
from nirgan_tpu_torch.models.layers import dtype_of
from nirgan_tpu_torch.train.state import TrainState, check_finite, param_dtype_of

__all__ = ["BaselineTask"]


class BaselineTask:
    satclip = False
    satclip_style = None
    lambda_rs = 0.0
    rs_losses = None
    netD = None

    def __init__(self, config: ConfigNode, device="cuda", seed: int = 0):
        """Build ``base_configs.model_name`` on ``device`` (the card unless
        the caller asks for the CPU) with weights drawn from ``seed``."""
        self.config = config
        self.opt = config.base_configs
        self.model_name = str(self.opt.model_name)
        self.device = torch.device(device)
        self.seed = int(seed)
        self.stager = DeviceStager(self.device)
        tpu = tpu_section(config)
        # the JAX baseline task reads no param_dtype: its parameters are f32
        # whatever the key says (a name it does not take still raises)
        param_dtype_of(tpu)
        # raise on the first non-finite loss or gradient (jax_debug_nans)
        self.debug_nans = bool(tpu.get("debug_nans", False))
        self.compute_dtype = dtype_of(tpu.compute_dtype)
        self.lr = float(self.opt.learning_rate)
        self.netG = self._model(self.seed).to(self.device)

    def _model(self, seed: int):
        return build_baseline(self.model_name, self.compute_dtype,
                              generator=torch.Generator().manual_seed(seed))

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Adam at ``base_configs.learning_rate``, step 0; a ``seed`` other
        than the task's draws the model anew from it, in place."""
        if seed is not None and int(seed) != self.seed:
            with torch.no_grad():
                self.netG.load_state_dict(self._model(int(seed)).state_dict())
            self.seed = int(seed)
        opt = torch.optim.Adam(self.netG.parameters(), lr=self.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return TrainState(step=0, opt_g=opt)

    def embed_coords(self, batch: Mapping) -> Mapping:
        """The baselines take no location: batches pass unchanged."""
        return batch

    def extract_batch(self, batch: Mapping) -> dict:
        """{"rgb": (B, 3, H, W), "nir": (B, 1, H, W)} host arrays -> NHWC
        f32 tensors on the task's device, through the task's stager."""
        rgb, nir = self.stager.to_device(
            [np.asarray(batch["rgb"], np.float32), np.asarray(batch["nir"], np.float32)])
        return {"rgb": rgb.permute(0, 2, 3, 1), "nir": nir.permute(0, 2, 3, 1)}

    def train_step(self, state: TrainState, batch: Mapping) -> dict:
        """One MSE step on an ``extract_batch`` batch; updates the model,
        the optimizer and ``state.step`` in place and returns ``train/loss``,
        ``model_loss/generator_total_loss`` and the ``train/*`` metrics as
        0-d f32 tensors on the device."""
        self.netG.train()
        nir = batch["nir"]
        pred = self.netG(batch["rgb"].to(self.compute_dtype))
        loss = mse_loss(pred, nir)
        state.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        if self.debug_nans:
            check_finite("model", loss, self.netG)
        state.opt_g.step()
        state.step += 1
        with torch.no_grad():
            metrics = {"train/loss": loss.detach().float(),
                       "model_loss/generator_total_loss": loss.detach().float()}
            metrics.update(calculate_metrics(pred.detach(), nir, phase="train"))
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Mapping):
        """(prediction f32 NHWC, ``val/*`` metrics); a ``_valid`` (B,) row
        mask drops padded rows."""
        self.netG.eval()
        pred = self.netG(batch["rgb"].to(self.compute_dtype))
        metrics = calculate_metrics(pred, batch["nir"], phase="val",
                                    mask=batch.get("_valid"))
        return pred.float(), metrics

    @torch.inference_mode()
    def predict_step(self, rgb, coords: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, 3, H, W) RGB -> (B, 1, H, W) NIR as f32 numpy; ``coords`` is
        ignored."""
        self.netG.eval()
        x = self.extract_batch({"rgb": rgb, "nir": np.zeros((1, 1, 1, 1),
                                                            np.float32)})["rgb"]
        pred = self.netG(x.to(self.compute_dtype)).float()
        return self.stager.to_host(pred.permute(0, 3, 1, 2)).result()

    def bind(self, state_dict: Mapping[str, torch.Tensor]) -> "BaselineTask":
        """Load the model's weights (the port's names, as
        ``weights.baseline_params_from_jax`` or
        ``weights.load_baseline_weights`` give them)."""
        self.netG.load_state_dict(state_dict, strict=True)
        return self

    def load_torch_weights(self, path: str) -> dict:
        """Weights-only warm start from a reference baseline ``.ckpt``
        (``train.py:61-65``): {"netG": state_dict}."""
        from nirgan_tpu_torch.weights import load_baseline_weights

        return {"netG": load_baseline_weights(path, self.model_name)}
