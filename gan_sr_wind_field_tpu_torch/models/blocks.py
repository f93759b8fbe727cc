"""Generator building blocks (eval mode), channels-last in and out.

Counterparts of ``ConvLReLU``, ``RDB`` and ``RRDB`` in
``gan_sr_wind_field_tpu/models/blocks.py``, ``conv_mode="3D"`` only. Weights
are held in PyTorch's ``(O, I, kx, ky, kz)`` layout and kept float32; each
forward casts them to the block's compute ``dtype``, as the flax modules
do. Growth convs carry no bias; the LFF 1³ conv keeps its bias. Padding is
zeros, SAME.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def kaiming_scaled_(w: torch.Tensor, scale: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """Kaiming-normal fan-in init times ``scale``: std = scale·sqrt(2/fan_in)
    (the JAX package's ``kaiming_scaled``)."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    with torch.no_grad():
        return w.normal_(0.0, scale * math.sqrt(2.0 / fan_in),
                         generator=generator)


def conv3d_cl(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """3D conv of a channels-last ``(N, X, Y, Z, C)`` tensor with a
    ``(O, C, kx, ky, kz)`` weight; zero SAME padding ``pad``. The permutes
    are views, so cuDNN runs it in NDHWC without copies."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=pad)
    return y.permute(0, 2, 3, 4, 1)


class ConvLReLU(nn.Module):
    """Bias-free (unless ``use_bias``) conv, optional LeakyReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, lrelu: bool = True,
                 negative_slope: float = 0.2, use_bias: bool = False,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 conv_mode: str = "3D",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_mode != "3D":
            raise NotImplementedError(
                f"conv_mode={conv_mode!r} is not ported; only '3D'"
            )
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k, k))
        kaiming_scaled_(self.weight, init_scale, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.padding = padding
        self.lrelu = lrelu
        self.negative_slope = negative_slope
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3d_cl(x.to(self.dtype), self.weight.to(self.dtype),
                      self.padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.lrelu:
            y = F.leaky_relu(y, self.negative_slope)
        return y


class RDB(nn.Module):
    """Residual dense block: ``num_convs - 1`` growth convs + LReLU over
    the growing concat, then the 1×1×1 LFF conv with bias, residual scaled
    by ``residual_scaling``."""

    def __init__(self, in_features: int, growth_channels: int,
                 num_convs: int = 5, lff_kern_size: int = 1,
                 residual_scaling: float = 0.2, negative_slope: float = 0.2,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 conv_mode: str = "3D",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(init_scale=init_scale, dtype=dtype, conv_mode=conv_mode,
                  generator=generator)
        self.convs = nn.ModuleList(
            ConvLReLU(in_features + growth_channels * i, growth_channels,
                      negative_slope=negative_slope, **kw)
            for i in range(num_convs - 1)
        )
        self.lff = ConvLReLU(
            in_features + growth_channels * (num_convs - 1), in_features,
            kernel_size=lff_kern_size, padding=(lff_kern_size - 1) // 2,
            lrelu=False, use_bias=True, **kw,
        )
        self.residual_scaling = residual_scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for conv in self.convs:
            feats = torch.cat([feats, conv(feats)], dim=-1)
        return self.lff(feats) * self.residual_scaling + x


class RRDB(nn.Module):
    """Residual-in-residual dense block: RDBs and a scaled outer residual."""

    def __init__(self, in_features: int, growth_channels: int,
                 num_convs: int = 5, lff_kern_size: int = 1,
                 rdb_residual_scaling: float = 0.2,
                 rrdb_residual_scaling: float = 0.2, num_rdbs: int = 3,
                 negative_slope: float = 0.2, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rdbs = nn.ModuleList(
            RDB(in_features, growth_channels, num_convs=num_convs,
                lff_kern_size=lff_kern_size,
                residual_scaling=rdb_residual_scaling,
                negative_slope=negative_slope, init_scale=init_scale,
                dtype=dtype, conv_mode=conv_mode, generator=generator)
            for _ in range(num_rdbs)
        )
        self.rrdb_residual_scaling = rrdb_residual_scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for rdb in self.rdbs:
            out = rdb(out)
        return out * self.rrdb_residual_scaling + x
