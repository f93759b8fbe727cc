from gan_sr_wind_field_tpu_torch.models.blocks import (
    RDB,
    RRDB,
    ConvLReLU,
    kaiming_scaled_,
)
from gan_sr_wind_field_tpu_torch.models.discriminator import Discriminator3D
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D

__all__ = ["Generator3D", "Discriminator3D", "RDB", "RRDB", "ConvLReLU",
           "kaiming_scaled_"]
