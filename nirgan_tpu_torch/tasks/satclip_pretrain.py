"""SatCLIP pretraining, counterpart of ``SatClipPretrainTask`` in
``nirgan_tpu/tasks/satclip_pretrain.py`` (reference
``SatCLIPLightningModule``, ``model/satclip/main.py:13-106``): contrastive
training of the dual encoder with AdamW and CLIP's weight-decay exclusion.

The frozen positional encoding runs on the host in float64 once a batch
(``extract_batch``); image and features reach the device through the
task's ``DeviceStager``.  The model trains in f32 on the task's device:
PyTorch's defaults hold there (on a card cuDNN's convolutions take TF32,
the matmuls full f32).  What the JAX step does through optax, this task
does so:

  * **AdamW** (lr 1e-4, weight decay 0.01) in two param groups: no decay
    for a parameter of fewer than 2 dimensions, one whose name holds "bn"
    or "ln", ``logit_scale`` or a bias (``_decay_mask``, ``main.py:77-94``).
    ``torch.optim.AdamW`` decays the old parameter and adds eps after the
    square root, as ``optax.adamw`` does.
  * **Frozen towers** (``moco_*``): every tower parameter but the head's
    has ``requires_grad=False``, so autograd never runs backward through
    the tower (JAX computes those gradients and zeroes the updates: the
    same updates).  The tower stays in train mode, so its batch norms'
    running statistics move, as in JAX.
  * **Accumulation** (``optax.MultiSteps``): with K micro-batches one
    update applies the mean of the K gradients; Adam's step counts updates;
    the batch-norm statistics move on every micro-batch.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from nirgan_tpu_torch.data.pipeline import DeviceStager
from nirgan_tpu_torch.models.layers import set_dropout_generator
from nirgan_tpu_torch.models.satclip.model import SatCLIP, satclip_loss
from nirgan_tpu_torch.models.satclip.positional_encoding import get_positional_encoding
from nirgan_tpu_torch.models.satclip.timm_towers import (
    PRETRAINED_TOWERS,
    resample_pos_embed,
)
from nirgan_tpu_torch.models.satclip.wrapper import CKPT_NAME
from nirgan_tpu_torch.weights import load_torch_state_dict

__all__ = ["SatClipPretrainTask", "SatClipTrainState", "decay_mask"]

HPARAMS_NAME = "satclip_hparams.json"


def decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """Parameter name -> whether weight decay applies (the reference's
    exclusion rule inverted, on the port's names)."""
    out = {}
    for name, p in model.named_parameters():
        low = name.lower()
        out[name] = not (p.ndim < 2 or "bn" in low or "ln" in low
                         or "logit_scale" in low or name.split(".")[-1] == "bias")
    return out


@dataclass
class SatClipTrainState:
    """Micro-batches trained (``step``, the JAX state's), the optimizer
    (whose own step counts updates), the dropout's generator, and the
    micro-batches accumulated toward the next update."""

    step: int
    opt: torch.optim.AdamW
    rng: torch.Generator
    accumulated: int = 0


class SatClipPretrainTask:
    def __init__(self, embed_dim: int = 256, le_type: str = "sphericalharmonics",
                 pe_type: str = "siren", legendre_polys: int = 10,
                 harmonics_calculation: str = "analytic", frequency_num: int = 16,
                 min_radius: float = 1, max_radius: float = 360,
                 vision_layers=(3, 4, 6, 3), vision_width: int = 64,
                 vision_patch_size: int = 32, image_resolution: int = 256,
                 in_channels: int = 4, capacity: int = 256,
                 num_hidden_layers: int = 2, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, accumulate_grad_batches: int = 1,
                 device="cuda", seed: int = 0):
        """Build the model on ``device`` (the card unless the caller asks
        for the CPU) with weights drawn from ``seed``."""
        self.device = torch.device(device)
        self.seed = int(seed)
        self.stager = DeviceStager(self.device)
        self.pretrained_head = None
        if isinstance(vision_layers, str) and vision_layers in PRETRAINED_TOWERS:
            # SSL4EO MoCo weights are 13-band Sentinel-2; the reference takes
            # in_chans from weights.meta and ignores the config value
            in_channels = 13
            self.pretrained_head = PRETRAINED_TOWERS[vision_layers][1]
        self.vision_layers = vision_layers
        self.posenc = get_positional_encoding(
            le_type, legendre_polys=legendre_polys,
            harmonics_calculation=harmonics_calculation,
            min_radius=min_radius, max_radius=max_radius,
            frequency_num=frequency_num)
        # what a checkpoint needs to rebuild the location tower
        self.hparams = {"le_type": le_type, "pe_type": pe_type,
                        "legendre_polys": legendre_polys,
                        "harmonics_calculation": harmonics_calculation,
                        "embed_dim": embed_dim}
        self.model = SatCLIP(
            embed_dim, vision_layers, vision_width, vision_patch_size,
            image_resolution, in_channels, pe_type, capacity, num_hidden_layers,
            self.posenc.embedding_dim, torch.Generator().manual_seed(self.seed),
        ).to(self.device)
        if self.pretrained_head is not None:
            for name, p in self.model.visual.named_parameters():
                p.requires_grad_(name.split(".")[0] == self.pretrained_head)
        self.model.train()
        self.image_resolution = image_resolution
        self.in_channels = in_channels
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        # reference trainer default: accumulate_grad_batches=16
        # (main.py:131): one optimizer update per K micro-batches
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))

    # ------------------------------------------------------------------ init
    def init_state(self) -> SatClipTrainState:
        """AdamW over the trainable parameters in a decay and a no-decay
        group, step 0, and the dropout's generator on the task's device,
        seeded with the task's seed."""
        mask = decay_mask(self.model)
        groups = [[], []]
        for name, p in self.model.named_parameters():
            if p.requires_grad:
                groups[0 if mask[name] else 1].append(p)
        opt = torch.optim.AdamW(
            [{"params": groups[0], "weight_decay": self.weight_decay},
             {"params": groups[1], "weight_decay": 0.0}],
            lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        rng = torch.Generator(device=self.device).manual_seed(self.seed)
        set_dropout_generator(self.model, rng)
        return SatClipTrainState(step=0, opt=opt, rng=rng)

    # --------------------------------------------------------------- weights
    def load_tower_weights(self, path: str) -> list[str]:
        """Warm-start a ``moco_*`` tower from a timm / torchgeo SSL4EO
        state_dict file (the reference's ``load_state_dict(...,
        strict=False)``, ``model.py:292``): a key of the tower with a
        matching shape is copied, any other is skipped, so the fresh head
        stays where the checkpoint has none or one of another width.  A
        ViT's ``pos_embed`` is first resampled to this model's grid as the
        JAX package resamples it.  Returns the keys loaded."""
        if self.pretrained_head is None:
            raise ValueError("tower weights only apply to moco_* vision options")
        sd = load_torch_state_dict(path)
        own = self.model.visual.state_dict()
        if "pos_embed" in sd and "pos_embed" in own:
            sd["pos_embed"] = resample_pos_embed(sd["pos_embed"],
                                                 own["pos_embed"].shape[1] - 1)
        loaded = []
        with torch.no_grad():
            for k, v in sd.items():
                if k in own and tuple(np.shape(v)) == tuple(own[k].shape):
                    own[k].copy_(torch.from_numpy(np.asarray(v)).to(own[k].dtype))
                    loaded.append(k)
        return loaded

    # ----------------------------------------------------------------- batch
    def extract_batch(self, batch: Mapping) -> dict:
        """{"image": (B, C, H, W), "point": (B, 2)} -> the NHWC f32 image and
        the f32 positional features, on the device.  The encoding runs in
        float64 on the host (reference ``model.py:329-331``); both arrays
        go through the stager, and the image turns NHWC on the device."""
        img = np.asarray(batch["image"], np.float32)
        feats = np.asarray(self.posenc(np.asarray(batch["point"], np.float64)),
                           np.float32)
        img_t, feats_t = self.stager.to_device([img, feats])
        return {"image": img_t.permute(0, 2, 3, 1).contiguous(),
                "loc_features": feats_t}

    # ------------------------------------------------------------------ step
    def train_step(self, state: SatClipTrainState, batch: Mapping) -> dict:
        """One micro-batch: forward in training mode (batch norms update
        their statistics, dropout draws from ``state.rng``), backward, and
        on every K-th micro-batch the AdamW update with the mean of the K
        gradients.  Returns {"train_loss": 0-d f32 tensor on the device}."""
        self.model.train()
        loss = satclip_loss(*self.model(batch["image"], batch["loc_features"]))
        loss.backward()
        self.step_optimizer(state)
        state.step += 1
        return {"train_loss": loss.detach()}

    def step_optimizer(self, state: SatClipTrainState) -> None:
        """Count in one micro-batch whose gradients backward has added to
        the parameters' ``.grad``; on the K-th, update with their mean and
        clear them."""
        state.accumulated += 1
        if state.accumulated < self.accumulate_grad_batches:
            return
        if self.accumulate_grad_batches > 1:
            with torch.no_grad():
                for group in state.opt.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(self.accumulate_grad_batches)
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        state.accumulated = 0

    @torch.no_grad()
    def eval_step(self, batch: Mapping) -> dict:
        """The loss in eval mode (running statistics, no dropout)."""
        self.model.eval()
        try:
            out = self.model(batch["image"], batch["loc_features"])
        finally:
            self.model.train()
        return {"val_loss": satclip_loss(*out).detach()}

    # ------------------------------------------------------------- location
    def location_encoder(self):
        """The frozen deployment view (what ``get_satclip`` returns,
        reference ``load.py:12-17``): a function (B, 2) lon/lat -> (B,
        embed_dim) float32 numpy, through a copy of the current location
        network in eval mode."""
        nnet = copy.deepcopy(self.model.location.nnet).eval()

        @torch.no_grad()
        def encode(coords) -> np.ndarray:
            feats = np.asarray(self.posenc(np.asarray(coords, np.float64)),
                               np.float32)
            x = self.stager.to_device([feats])[0]
            return self.stager.to_host(nnet(x).float()).result()

        return encode

    # ------------------------------------------------------------ checkpoint
    def save(self, out_dir: str) -> str:
        """``<out_dir>/satclip.ckpt`` in the reference's Lightning layout
        (``state_dict`` under the ``model.`` prefix, ``hyper_parameters``)
        and the ``satclip_hparams.json`` sidecar the JAX CLI writes beside
        its checkpoint.  Returns the checkpoint's path."""
        os.makedirs(out_dir, exist_ok=True)
        sd = {f"model.{k}": v.detach().cpu()
              for k, v in self.model.state_dict().items()}
        path = os.path.join(out_dir, CKPT_NAME)
        torch.save({"state_dict": sd, "hyper_parameters": dict(self.hparams)}, path)
        with open(os.path.join(out_dir, HPARAMS_NAME), "w") as f:
            json.dump(self.hparams, f)
        return path
