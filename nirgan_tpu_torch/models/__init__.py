from nirgan_tpu_torch.models.discriminator import NLayerDiscriminator, PixelDiscriminator
from nirgan_tpu_torch.models.factory import define_D, define_G, define_G_inject
from nirgan_tpu_torch.models.generator import ResnetBlock, ResnetGenerator
from nirgan_tpu_torch.models.unet import UnetGenerator

__all__ = ["define_D", "define_G", "define_G_inject", "NLayerDiscriminator",
           "PixelDiscriminator", "ResnetBlock", "ResnetGenerator", "UnetGenerator"]
