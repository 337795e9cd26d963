"""SatCLIP, counterpart of ``nirgan_tpu/models/satclip``: the frozen location
tower (coords -> 256-d embedding) with its spherical harmonics, SIREN
encoder and the wrapper that loads it, and for pretraining the contrastive
model (``model.py``), its timm towers (``timm_towers.py``) and the
positional encodings (``positional_encoding.py``)."""

from nirgan_tpu_torch.models.satclip.location_encoder import LocationEncoder
from nirgan_tpu_torch.models.satclip.wrapper import (
    SatClipWrapper,
    get_satclip_loc_encoder,
)

__all__ = ["LocationEncoder", "SatClipWrapper", "get_satclip_loc_encoder"]
