from nirgan_tpu_torch.models.factory import define_G
from nirgan_tpu_torch.models.generator import ResnetBlock, ResnetGenerator

__all__ = ["define_G", "ResnetBlock", "ResnetGenerator"]
