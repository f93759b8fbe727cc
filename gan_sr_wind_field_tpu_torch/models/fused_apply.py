"""Generator forward with a pluggable trunk, and the eval-mode forward
with the RRDB-trunk kernel.

``generate_fused(G, lr, z)`` computes what ``Generator3D.forward`` computes
in eval mode, but runs the trunk, the dominant cost, as the one-call trunk
kernel (``ops/rdb_trunk.py``). Counterpart of
``gan_sr_wind_field_tpu/models/fused_apply.py``. The layers around the
trunk (feature conv, lr_conv and the long skip, upsampling convs, terrain
branch, hr_conv0, channel dropout and hr_conv1) are plain ``F.conv3d``
calls; the JAX package's lane tricks for them (split_hr_out, tap-stacked
hr_conv1) are the same math and need no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gan_sr_wind_field_tpu_torch.models.blocks import channel_dropout
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    rrdb_trunk,
)
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy


def _head_features(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                   trunk_fn: Callable):
    """The generator up to, not including, hr_conv0: the HR-resolution
    features x and the terrain features t, both channels-last."""
    x = G.feature_conv(lr.to(G.dtype))
    x = x + G.lr_conv(trunk_fn(x))  # long skip connection
    for up in G.upconvs:
        x = up(upsample_nearest_xy(x, 2))
    t = G.terrain_conv1(G.terrain_conv0(z_terrain.to(G.dtype)))
    return x, t


def generator_forward(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                      trunk_fn: Callable, train: bool = False,
                      dropout_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Generator forward with a pluggable trunk; returns float32
    (N, x·s, y·s, zl, out_channels). With ``train`` and a dropout
    probability p > 0, whole channels after lrelu(hr_conv0) are dropped:
    ``dropout_mask`` is the boolean keep mask (N, 1, 1, 1, C), drawn with
    keep probability 1 − p from ``generator`` when not given."""
    x, t = _head_features(G, lr, z_terrain, trunk_fn)
    x = F.leaky_relu(G.hr_conv0_x(x) + G.hr_conv0_t(t), G.negative_slope)
    if train and G.dropout_probability > 0.0:
        x = channel_dropout(x, G.dropout_probability, dropout_mask,
                            generator)
    return G.hr_conv1(x).float()


def trunk_geometry(G) -> dict:
    """The trunk kernels' geometry arguments for generator G."""
    return dict(gc=G.rdb_growth_channels, num_convs=G.num_rdb_convs,
                rdb_scale=G.rdb_residual_scaling,
                rrdb_scale=G.rrdb_residual_scaling,
                negative_slope=G.negative_slope)


def kernel_trunk_fn(G, packed: Optional[dict] = None) -> Callable:
    """The trunk as one launch of the trunk kernel, for forwards that need
    no gradient. ``packed`` is ``pack_trunk_weights(G.rrdbs, G.dtype)`` on
    the input's device; packed on each call when not given."""
    def trunk_fn(x):
        p = packed
        if p is None:
            p = pack_trunk_weights(G.rrdbs, G.dtype, x.device)
        return rrdb_trunk(p, x.contiguous(), **trunk_geometry(G))

    return trunk_fn


def generate_fused(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                   packed: Optional[dict] = None) -> torch.Tensor:
    """``G.forward`` with the trunk kernel. ``packed`` is
    ``pack_trunk_weights(G.rrdbs, G.dtype)`` on lr's device; pass it to
    skip repacking on every call."""
    return generator_forward(G, lr, z_terrain, kernel_trunk_fn(G, packed))
