"""The frozen SatCLIP location tower (coords -> 256-d embedding), counterpart
of ``nirgan_tpu/models/satclip``: spherical harmonics, the SIREN location
encoder and the wrapper that loads it.  The contrastive model and its image
towers are not ported."""

from nirgan_tpu_torch.models.satclip.location_encoder import LocationEncoder
from nirgan_tpu_torch.models.satclip.wrapper import (
    SatClipWrapper,
    get_satclip_loc_encoder,
)

__all__ = ["LocationEncoder", "SatClipWrapper", "get_satclip_loc_encoder"]
