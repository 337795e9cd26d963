from nirgan_tpu_torch.models.discriminator import NLayerDiscriminator
from nirgan_tpu_torch.models.factory import define_D, define_G, define_G_inject
from nirgan_tpu_torch.models.generator import ResnetBlock, ResnetGenerator

__all__ = ["define_D", "define_G", "define_G_inject", "NLayerDiscriminator", "ResnetBlock",
           "ResnetGenerator"]
