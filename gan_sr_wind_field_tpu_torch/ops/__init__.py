from gan_sr_wind_field_tpu_torch.ops.metrics import psnr
from gan_sr_wind_field_tpu_torch.ops.physics import (
    gradient_norm_factors,
    gradient_xy,
    gradient_z_nonuniform,
    wind_field_gradient,
)
from gan_sr_wind_field_tpu_torch.ops.resize import (
    decimate_xy,
    upsample_nearest_xy,
    upsample_trilinear_xy,
)

__all__ = [
    "gradient_norm_factors",
    "gradient_xy",
    "gradient_z_nonuniform",
    "wind_field_gradient",
    "psnr",
    "decimate_xy",
    "upsample_nearest_xy",
    "upsample_trilinear_xy",
]
