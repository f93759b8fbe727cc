"""Building blocks, channels-last in and out.

Counterparts of ``HorizontalConv3D``, ``ConvLReLU``, ``RDB``, ``RRDB`` and
``DiscriminatorBlock`` in ``gan_sr_wind_field_tpu/models/blocks.py``, in
both conv modes. ``conv_mode="3D"`` weights are held in PyTorch's
``(O, I, kx, ky, kz)`` layout; ``"horizontal_3D"`` ones, one unshared
kernel per z-window, as ``(W, O, I, kx, ky, kz)``: a stack of per-window
``Conv3d`` weights. Weights are kept float32; each forward casts them to
the block's compute ``dtype``, as the flax modules do. Growth convs carry
no bias, and no horizontal conv has one; the LFF 1³ conv keeps its bias
and stays a shared 3D conv in either mode. Padding is zeros.
``BatchNorm`` is flax's ``nn.BatchNorm``, not PyTorch's: it keeps the
biased batch variance in its running statistics. ``instance_norm`` is
flax's ``GroupNorm`` with one channel per group and no affine.

On the spatial axis of a mesh (``parallel/halo.py``) a block's input is
this rank's x slab and its forward takes the ``slab``: each conv first
takes ``padding_x`` planes from the neighbours (the halo exchange) and
then convolves with no x padding, in either conv mode (a horizontal
conv's windows lie along z, so its x halo is the same); the 1×1×1 LFF
takes none. ``instance_norm`` sums each sample's moments over the slabs.

On the model axis of a mesh (``parallel/model.py``) a ``ConvLReLU`` whose
``channels`` is set (``Generator3D.shard_channels``) is given this rank's
output channels of its weight and bias: it convolves the whole input
(after its x halo) with them and gathers the whole output over the model
group, the Megatron pair around the conv.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gan_sr_wind_field_tpu_torch.parallel.collectives import group_sum
from gan_sr_wind_field_tpu_torch.parallel.halo import halo_exchange
from gan_sr_wind_field_tpu_torch.parallel.model import (
    gather_channels,
    to_model,
)


def kaiming_scaled_(w: torch.Tensor, scale: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """Kaiming-normal fan-in init times ``scale``: std = scale·sqrt(2/fan_in)
    (the JAX package's ``kaiming_scaled``). fan_in is the product of every
    axis but the first (the output's); a 6-D horizontal kernel
    ``(W, O, I, kx, ky, kz)`` counts its windows too, W·I·kx·ky·kz, as
    flax's ``variance_scaling`` reads the whole (W, kx, ky, kz, I, O)
    kernel."""
    if w.is_meta:
        # no values to draw (models/generator.py:empty_generator), and a
        # draw on the meta device imports torch._dynamo: seconds at start
        return w
    if w.dim() == 6:
        fan_in = w.shape[0] * math.prod(w.shape[2:])
    else:
        fan_in = math.prod(w.shape[1:])
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


def horizontal_windows(z_in: int, kz: int, pz: int, sz: int) -> int:
    """The z-window count of a horizontal conv, (Zin − kz + 2·pz)//sz + 1:
    one unshared kernel, and one output layer, per window."""
    return (z_in - kz + 2 * pz) // sz + 1


def horizontal_conv3d_cl(x: torch.Tensor, w: torch.Tensor, padding,
                         strides) -> torch.Tensor:
    """JAX ``HorizontalConv3D`` of a channels-last ``(N, X, Y, Z, C)``
    tensor with a ``(W, O, C, kx, ky, kz)`` weight; → (N, X', Y', W, O).

    z is zero-padded by pz and window w starts at z0 = w·sz; its kz layers
    are folded into the channels kz-major, C-minor, and each window is a
    2D conv with xy stride (sx, sy) and padding (px, py). All windows run
    as one ``F.conv2d`` with ``groups=W``: the input is laid out as
    (N, X, Y, W·kz·C), viewed channels-last, and the weight as
    (W·O, kz·C, kx, ky)."""
    W, O, C, kx, ky, kz = w.shape
    px, py, pz = _triple(padding)
    sx, sy, sz = _triple(strides)
    N, X, Y = x.shape[:3]
    xp = F.pad(x, (0, 0, pz, pz))
    win = xp.unfold(3, kz, sz)  # (N, X, Y, W, C, kz), a view
    win = win.transpose(4, 5).reshape(N, X, Y, W * kz * C)
    w2 = w.permute(0, 1, 5, 2, 3, 4).reshape(W * O, kz * C, kx, ky)
    y = F.conv2d(win.permute(0, 3, 1, 2), w2, stride=(sx, sy),
                 padding=(px, py), groups=W)
    return y.permute(0, 2, 3, 1).reshape(N, y.shape[2], y.shape[3], W, O)


def instance_norm(x: torch.Tensor, dtype: torch.dtype,
                  slab=None) -> torch.Tensor:
    """flax ``GroupNorm(group_size=1, use_bias=False, use_scale=False,
    epsilon=1e-5)`` of a channels-last tensor: per sample and channel over
    every other axis, statistics in float32 (variance E[x²] − E[x]²,
    clipped at 0), rounded to ``dtype`` once. No parameters, no running
    statistics. With a ``slab`` (x is this rank's x slab) the moments are
    summed over the slabs of the sample, differentiably."""
    xf = x.float()
    axes = tuple(range(1, x.dim() - 1))
    if slab is None:
        mean = xf.mean(axes, keepdim=True)
        ex2 = (xf * xf).mean(axes, keepdim=True)
    else:
        count = math.prod(x.shape[1:-1]) * slab.size
        sums = group_sum(torch.cat([xf.sum(axes, keepdim=True),
                                    (xf * xf).sum(axes, keepdim=True)]),
                         slab.group) / count
        mean, ex2 = sums.chunk(2)
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(dtype)


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
    once, at the end.

    The batch sums of x and x² accumulate in float64: where a channel's
    mean is large against its spread, the one-pass variance cancels most
    of float32's digits, and its value then hangs on the order of the
    sums (at milestone9k's D about 2e-3 of D's gradients, float32 sums
    over two halves of a batch against one). With a process ``group``
    (the mesh's ranks, ``Discriminator3D.sync_batch_norm``) the sums are
    over every rank's rows and slabs, in one differentiable all_reduce, and
    the count is the local one times the group's size, so every rank
    normalises with, and moves its running statistics by, the same values.
    After D's gather along x each rank of a data row holds the same copy:
    the sums then count each row s times, and so does the count."""

    MOMENTUM = 0.9
    EPSILON = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype
        self.group = None

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            sums = torch.cat([xf.sum(axes, dtype=torch.float64),
                              (xf * xf).sum(axes, dtype=torch.float64)])
            count = xf.numel() // xf.shape[-1]
            if self.group is not None:
                sums = group_sum(sums, self.group)
                count *= dist.get_world_size(self.group)
            mean, ex2 = (sums / count).chunk(2)
            var = torch.clamp_min(ex2 - mean * mean, 0.0).float()
            mean = mean.float()
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
    """Bias-free (unless ``use_bias``) conv, optional batch or instance
    norm, optional LeakyReLU (the CNA order). ``conv_mode="horizontal_3D"``
    swaps in the per-z-window conv (``horizontal_conv3d_cl``), which has no
    bias whatever ``use_bias`` says, as JAX's ``HorizontalConv3D`` creates
    none; its window count comes from ``z_in``, the input's z extent."""

    def __init__(self, in_channels: int, features: int, kernel_size=3,
                 padding=1, lrelu: bool = True,
                 negative_slope: float = 0.2, use_bias: bool = False,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 conv_mode: str = "3D", strides=1, norm: str = "",
                 z_in: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_mode not in ("3D", "horizontal_3D"):
            raise ValueError(f"unknown conv_mode {conv_mode!r}")
        if norm not in ("", "batch", "instance"):
            raise NotImplementedError(f"Unknown norm type {norm!r}")
        k, p, s = _triple(kernel_size), _triple(padding), _triple(strides)
        shape = (features, in_channels, *k)
        self.horizontal = conv_mode == "horizontal_3D"
        if self.horizontal:
            if z_in is None:
                raise ValueError("a horizontal_3D conv needs its input's z "
                                 "extent (z_in)")
            shape = (horizontal_windows(z_in, k[2], p[2], s[2]),) + shape
            use_bias = False
        self.weight = nn.Parameter(torch.empty(shape))
        kaiming_scaled_(self.weight, init_scale, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bn = BatchNorm(features, dtype=dtype) if norm == "batch" else None
        self.instance = norm == "instance"
        self.padding = p
        self.strides = s
        self.lrelu = lrelu
        self.negative_slope = negative_slope
        self.dtype = dtype
        # this rank's place on a model axis when its output channels are
        # sharded (parallel/model.py), else None
        self.channels = None

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False, slab=None) -> torch.Tensor:
        """``slab``: x is this rank's x slab on a spatial axis
        (``parallel/halo.py``): the conv takes its x halo first and runs
        with no x padding. With ``channels`` set the weight and bias hold
        this rank's output channels, and the output is gathered whole;
        the input's cotangent is summed over the model group."""
        conv = horizontal_conv3d_cl if self.horizontal else conv3d_cl
        x, pad = x.to(self.dtype), self.padding
        if slab is not None:
            x = halo_exchange(x, pad[0], slab)
            pad = (0,) + pad[1:]
        if self.channels is not None:
            x = to_model(x, self.channels)
        y = conv(x, self.weight.to(self.dtype), pad, self.strides)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.channels is not None:
            y = gather_channels(y, self.channels)
        if self.bn is not None:
            y = self.bn(y, train, update_stats)
        elif self.instance:
            y = instance_norm(y, self.dtype, slab)
        if self.lrelu:
            y = F.leaky_relu(y, self.negative_slope)
        return y


class RDB(nn.Module):
    """Residual dense block: ``num_convs - 1`` growth convs + LReLU over
    the growing concat, then the 1×1×1 LFF conv with bias, residual scaled
    by ``residual_scaling``. The LFF is a shared 3D conv in either conv
    mode, as JAX's bare ``nn.Conv`` is."""

    def __init__(self, in_features: int, growth_channels: int,
                 num_convs: int = 5, lff_kern_size: int = 1,
                 residual_scaling: float = 0.2, negative_slope: float = 0.2,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 conv_mode: str = "3D", z_in: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(init_scale=init_scale, dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            ConvLReLU(in_features + growth_channels * i, growth_channels,
                      negative_slope=negative_slope, conv_mode=conv_mode,
                      z_in=z_in, **kw)
            for i in range(num_convs - 1)
        )
        self.lff = ConvLReLU(
            in_features + growth_channels * (num_convs - 1), in_features,
            kernel_size=lff_kern_size, padding=(lff_kern_size - 1) // 2,
            lrelu=False, use_bias=True, **kw,
        )
        self.residual_scaling = residual_scaling

    def forward(self, x: torch.Tensor, slab=None) -> torch.Tensor:
        feats = x
        for conv in self.convs:
            feats = torch.cat([feats, conv(feats, slab=slab)], dim=-1)
        return self.lff(feats, slab=slab) * self.residual_scaling + x


class RRDB(nn.Module):
    """Residual-in-residual dense block: RDBs and a scaled outer residual."""

    def __init__(self, in_features: int, growth_channels: int,
                 num_convs: int = 5, lff_kern_size: int = 1,
                 rdb_residual_scaling: float = 0.2,
                 rrdb_residual_scaling: float = 0.2, num_rdbs: int = 3,
                 negative_slope: float = 0.2, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 z_in: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rdbs = nn.ModuleList(
            RDB(in_features, growth_channels, num_convs=num_convs,
                lff_kern_size=lff_kern_size,
                residual_scaling=rdb_residual_scaling,
                negative_slope=negative_slope, init_scale=init_scale,
                dtype=dtype, conv_mode=conv_mode, z_in=z_in,
                generator=generator)
            for _ in range(num_rdbs)
        )
        self.rrdb_residual_scaling = rrdb_residual_scaling

    def forward(self, x: torch.Tensor, slab=None) -> torch.Tensor:
        out = x
        for rdb in self.rdbs:
            out = rdb(out, slab)
        return out * self.rrdb_residual_scaling + x


class DiscriminatorBlock(nn.Module):
    """conv (+norm) + LeakyReLU, then a strided (4, 4, feat_kern_size) conv
    (+norm) + LeakyReLU with padding 1 and stride (2, 2, 2) when
    ``halve_z``, else (2, 2, 1). ``drop_first_norm`` skips the first
    conv's norm (block 0). Both convs take ``conv_mode`` and ``norm``;
    ``z_in`` is the input's z extent (horizontal mode)."""

    def __init__(self, in_channels: int, features: int,
                 feat_kern_size: int = 3, norm: str = "batch",
                 drop_first_norm: bool = False, halve_z: bool = False,
                 negative_slope: float = 0.2, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 z_in: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(negative_slope=negative_slope, init_scale=init_scale,
                  dtype=dtype, conv_mode=conv_mode, generator=generator)
        pad = (feat_kern_size - 1) // 2
        self.conv = ConvLReLU(in_channels, features,
                              kernel_size=feat_kern_size, padding=pad,
                              norm="" if drop_first_norm else norm,
                              z_in=z_in, **kw)
        z_mid = (None if z_in is None else
                 horizontal_windows(z_in, feat_kern_size, pad, 1))
        self.strided_conv = ConvLReLU(
            features, features, kernel_size=(4, 4, feat_kern_size),
            strides=(2, 2, 2) if halve_z else (2, 2, 1), padding=1,
            norm=norm, z_in=z_mid, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = False, slab=None) -> torch.Tensor:
        """On a ``slab`` the strided conv needs an even slab width (so
        that every slab starts at an even plane)."""
        x = self.conv(x, train, update_stats, slab)
        return self.strided_conv(x, train, update_stats, slab)
