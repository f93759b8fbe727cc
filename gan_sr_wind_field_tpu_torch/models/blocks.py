"""Building blocks, channels-last in and out.

Counterparts of ``ConvLReLU``, ``RDB``, ``RRDB`` and ``DiscriminatorBlock``
in ``gan_sr_wind_field_tpu/models/blocks.py``, ``conv_mode="3D"`` only.
Weights are held in PyTorch's ``(O, I, kx, ky, kz)`` layout and kept
float32; each forward casts them to the block's compute ``dtype``, as the
flax modules do. Growth convs carry no bias; the LFF 1³ conv keeps its
bias. Padding is zeros. ``BatchNorm`` is flax's ``nn.BatchNorm``, not
PyTorch's: it keeps the biased batch variance in its running statistics.
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


def conv3d_cl(x: torch.Tensor, w: torch.Tensor, pad: int,
              stride=1) -> torch.Tensor:
    """3D conv of a channels-last ``(N, X, Y, Z, C)`` tensor with a
    ``(O, C, kx, ky, kz)`` weight; zero padding ``pad`` on every face. The
    permutes are views, so cuDNN runs it in NDHWC without copies."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=pad, stride=stride)
    return y.permute(0, 2, 3, 4, 1)


def channel_dropout(x: torch.Tensor, p: float,
                    keep: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Dropout of whole channels of a channels-last tensor (torch
    Dropout3d, flax ``Dropout(broadcast_dims=(1, 2, 3))``): ``keep`` is a
    boolean (N, 1, 1, 1, C) mask, drawn with keep probability 1 − p from
    ``generator`` when not given; kept channels are scaled by 1/(1 − p),
    in x's dtype."""
    if keep is None:
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = _draw_keep(shape, p, generator, x.device)
    return torch.where(keep.to(x.device), x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _draw_keep(shape, p: float, generator, device):
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout_scale(n: int, c: int, p: float, dtype: torch.dtype, device,
                  keep: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """The channel-dropout scale (n, c) in ``dtype`` for the HR-head
    kernel: 1/(1 − p) where ``keep`` is true, else 0. ``keep`` is the
    boolean (n, 1, 1, 1, c) mask, drawn as ``channel_dropout`` draws it
    (the same numbers from the same generator) when not given."""
    if keep is None:
        keep = _draw_keep((n, 1, 1, 1, c), p, generator, device)
    scale = torch.where(keep.to(device).reshape(n, c), 1.0 / (1.0 - p), 0.0)
    return scale.to(dtype)


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    (channel) axis, as the JAX package's blocks use it. Statistics in
    float32 (variance E[x²] − E[x]², clipped at 0); in training the batch
    statistics normalise, and with ``update_stats`` the running ones move
    as r ← 0.9·r + 0.1·batch, in place. The result is rounded to ``dtype``
    once, at the end."""

    MOMENTUM = 0.9
    EPSILON = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            if update_stats:
                m = self.MOMENTUM
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.EPSILON) * self.scale)
        return (y + self.bias).to(self.dtype)


class ConvLReLU(nn.Module):
    """Bias-free (unless ``use_bias``) conv, optional batch norm, optional
    LeakyReLU (the CNA order)."""

    def __init__(self, in_channels: int, features: int, kernel_size=3,
                 padding: int = 1, lrelu: bool = True,
                 negative_slope: float = 0.2, use_bias: bool = False,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 conv_mode: str = "3D", strides=1, norm: str = "",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_mode != "3D":
            raise NotImplementedError(
                f"conv_mode={conv_mode!r} is not ported (ROADMAP.md); "
                "only '3D'"
            )
        if norm not in ("", "batch"):
            raise NotImplementedError(f"norm={norm!r} is not ported "
                                      "(ROADMAP.md); only '' and 'batch'")
        self.weight = nn.Parameter(torch.empty(features, in_channels,
                                               *_triple(kernel_size)))
        kaiming_scaled_(self.weight, init_scale, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bn = BatchNorm(features, dtype=dtype) if norm else None
        self.padding = padding
        self.strides = _triple(strides)
        self.lrelu = lrelu
        self.negative_slope = negative_slope
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        y = conv3d_cl(x.to(self.dtype), self.weight.to(self.dtype),
                      self.padding, self.strides)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.bn is not None:
            y = self.bn(y, train, update_stats)
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


class DiscriminatorBlock(nn.Module):
    """conv (+norm) + LeakyReLU, then a strided (4, 4, feat_kern_size) conv
    (+norm) + LeakyReLU with padding 1 and stride (2, 2, 2) when
    ``halve_z``, else (2, 2, 1). ``drop_first_norm`` skips the first
    conv's norm (block 0)."""

    def __init__(self, in_channels: int, features: int,
                 feat_kern_size: int = 3, norm: str = "batch",
                 drop_first_norm: bool = False, halve_z: bool = False,
                 negative_slope: float = 0.2, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(negative_slope=negative_slope, init_scale=init_scale,
                  dtype=dtype, conv_mode=conv_mode, generator=generator)
        self.conv = ConvLReLU(in_channels, features,
                              kernel_size=feat_kern_size,
                              padding=(feat_kern_size - 1) // 2,
                              norm="" if drop_first_norm else norm, **kw)
        self.strided_conv = ConvLReLU(
            features, features, kernel_size=(4, 4, feat_kern_size),
            strides=(2, 2, 2) if halve_z else (2, 2, 1), padding=1,
            norm=norm, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        x = self.conv(x, train, update_stats)
        return self.strided_conv(x, train, update_stats)
