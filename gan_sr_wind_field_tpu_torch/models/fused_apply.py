"""Generator forward with a pluggable trunk and head, and the eval-mode
forward with the RRDB-trunk kernel (and optionally the HR-head kernel).

``generate_fused(G, lr, z)`` computes what ``Generator3D.forward`` computes
in eval mode, but runs the trunk, the dominant cost, as the one-call trunk
kernel (``ops/rdb_trunk.py``). Counterpart of
``gan_sr_wind_field_tpu/models/fused_apply.py``. With a head function
(``kernel_head_fn``) hr_conv0, its LeakyReLU and the channel dropout run as
the HR-head kernel (``ops/hr_head.py``), as the JAX package's
``pallas_head`` does. The other layers around the trunk (feature conv,
lr_conv and the long skip, upsampling convs, terrain branch and hr_conv1)
are plain ``F.conv3d`` calls; the JAX package's lane tricks for them
(split_hr_out, tap-stacked hr_conv1) are the same math and need no
counterpart here.

Serving may swap in calibrated int8: ``qhead`` runs hr_conv0's x-part as
``ops/quant.py:split_head_conv_int8`` (the terrain part stays exact), and
``qtrunk`` the trunk as ``ops/quant_trunk.py:trunk_int8_apply``.
``trunk_input_features`` and ``head_features_fused`` are their calibration
probes. A ``conv_mode="horizontal_3D"`` generator runs its one unsplit
hr_conv0 on the concat of x and t, with neither head function nor int8.
Whichever computes it, the head (hr_conv0, its LeakyReLU and dropout) is
the device span ``G.hr_head`` (``utils/spans.py``), forward and backward,
with the attribute ``impl``: "kernel", "modules" or "int8". Which forwards
take the head kernel is ``models/generator.py:choose_head``'s decision.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gan_sr_wind_field_tpu_torch.models.blocks import (
    channel_dropout,
    dropout_scale,
)
from gan_sr_wind_field_tpu_torch.ops.hr_head import hr_head
from gan_sr_wind_field_tpu_torch.ops.quant import split_head_conv_int8
from gan_sr_wind_field_tpu_torch.ops.quant_trunk import trunk_int8_apply
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    rrdb_trunk,
)
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy
from gan_sr_wind_field_tpu_torch.utils import spans


def _x_features(G, lr: torch.Tensor, trunk_fn: Callable,
                slab=None) -> torch.Tensor:
    """The HR-resolution features that enter hr_conv0's x-part."""
    x = G.feature_conv(lr.to(G.dtype), slab=slab)
    x = x + G.lr_conv(trunk_fn(x), slab=slab)  # long skip connection
    for up in G.upconvs:
        # the nearest upsample is local to the slab
        x = up(upsample_nearest_xy(x, 2), slab=slab)
    return x


def _head_features(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                   trunk_fn: Callable, slab=None):
    """The generator up to, not including, hr_conv0: the HR-resolution
    features x and the terrain features t, both channels-last."""
    x = _x_features(G, lr, trunk_fn, slab)
    t = G.terrain_conv1(G.terrain_conv0(z_terrain.to(G.dtype), slab=slab),
                        slab=slab)
    return x, t


def generator_forward(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                      trunk_fn: Callable, train: bool = False,
                      dropout_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      head_fn: Optional[Callable] = None,
                      qhead=None, slab=None) -> torch.Tensor:
    """Generator forward with a pluggable trunk; returns float32
    (N, x·s, y·s, zl, out_channels). With ``train`` and a dropout
    probability p > 0, whole channels after lrelu(hr_conv0) are dropped:
    ``dropout_mask`` is the boolean keep mask (N, 1, 1, 1, C), drawn with
    keep probability 1 − p from ``generator`` when not given. ``head_fn``
    (x, t, scale) -> h, when given, computes hr_conv0, its LeakyReLU and
    the dropout scale (N, C) or None in one (``kernel_head_fn``); the same
    channels are drawn from the same generator either way. ``qhead`` (a
    ``QuantizedHead``, serving only: it raises under ``train``) computes
    hr_conv0's x-part in int8, the terrain part exactly, and leaves
    ``head_fn`` unused. With a ``slab`` (``parallel/halo.py``) lr and
    z_terrain are this rank's x slabs, every conv takes its x halo, and
    the output is the slab's; the trunk function then runs the modules on
    the slab and neither a head function nor int8 is given
    (``Generator3D.forward`` refuses them)."""
    if qhead is not None and train:
        raise ValueError("int8 head quantization is a serving-only option "
                         "(the terrain part stays exact)")
    x, t = _head_features(G, lr, z_terrain, trunk_fn, slab)
    p = G.dropout_probability if train else 0.0
    # the HR head, whichever computes it, and its backward: one span
    with spans.device_span("G.hr_head") as head:
        head.set(impl="int8" if qhead is not None
                 else "modules" if head_fn is None else "kernel")
        x, t = head.inputs(x, t)
        if G.conv_mode != "3D":
            # one unsplit hr_conv0 on the concat (JAX generator.py:191-204)
            x = F.leaky_relu(G.hr_conv0(torch.cat([x, t], dim=-1),
                                        slab=slab), G.negative_slope)
            if p > 0.0:
                x = channel_dropout(x, p, dropout_mask, generator)
        elif qhead is not None:
            cx = split_head_conv_int8(x, qhead, (G.hr_kern_size - 1) // 2,
                                      out_dtype=G.dtype)
            x = F.leaky_relu(cx + G.hr_conv0_t(t), G.negative_slope)
        elif head_fn is None:
            x = F.leaky_relu(G.hr_conv0_x(x, slab=slab)
                             + G.hr_conv0_t(t, slab=slab), G.negative_slope)
            if p > 0.0:
                x = channel_dropout(x, p, dropout_mask, generator)
        else:
            scale = None
            if p > 0.0:
                scale = dropout_scale(x.shape[0],
                                      G.hr_conv0_x.weight.shape[0], p,
                                      G.dtype, x.device, dropout_mask,
                                      generator)
            x = head_fn(x, t.to(G.dtype), scale)
        x = head.output(x)
    return G.hr_conv1(x, slab=slab).float()


def kernel_head_fn(G, packed: Optional[torch.Tensor] = None) -> Callable:
    """hr_conv0 with its LeakyReLU and dropout scale as the HR-head kernel
    (``ops/hr_head.py:hr_head``): differentiable where a gradient is
    needed, one launch on ``packed`` (``pack_head_weights`` of G's
    hr_conv0 weights in G.dtype on the input's device) where not."""
    def head_fn(x, t, scale):
        dt = G.dtype
        return hr_head(G.hr_conv0_x.weight.to(dt), G.hr_conv0_t.weight.to(dt),
                       x, t, scale, k=G.hr_kern_size,
                       negative_slope=G.negative_slope, packed=packed)

    return head_fn


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


def int8_trunk_fn(G, qtrunk) -> Callable:
    """The trunk as ``trunk_int8_apply`` of the calibrated ``qtrunk``."""
    return lambda x: trunk_int8_apply(qtrunk, x, out_dtype=G.dtype)


def generate_fused(G, lr: torch.Tensor, z_terrain: torch.Tensor,
                   packed: Optional[dict] = None,
                   head_packed: Optional[torch.Tensor] = None,
                   head: bool = False, qhead=None,
                   qtrunk=None) -> torch.Tensor:
    """``G.forward`` with the trunk kernel, and with ``head`` the HR-head
    kernel. ``packed`` is ``pack_trunk_weights(G.rrdbs, G.dtype)`` and
    ``head_packed`` ``pack_head_weights`` of G's hr_conv0 weights, both on
    lr's device; pass them to skip repacking on every call. ``qtrunk``
    swaps the trunk kernel for the int8 trunk, ``qhead`` hr_conv0's x-part
    (and the HR-head kernel, as in the JAX package) for the int8 head.
    A horizontal_3D generator raises ValueError: the kernels need "3D"."""
    if G.conv_mode != "3D":
        raise ValueError(f"conv_mode={G.conv_mode!r}: the trunk kernel "
                         "needs '3D' (JAX trunk_fusable)")
    trunk_fn = (int8_trunk_fn(G, qtrunk) if qtrunk is not None
                else kernel_trunk_fn(G, packed))
    use_head = head and qhead is None
    return generator_forward(
        G, lr, z_terrain, trunk_fn,
        head_fn=kernel_head_fn(G, head_packed) if use_head else None,
        qhead=qhead)


def trunk_input_features(G, lr: torch.Tensor) -> torch.Tensor:
    """feature_conv's output, the trunk's input (the int8 trunk's
    calibration probe)."""
    return G.feature_conv(lr.to(G.dtype))


def head_features_fused(G, lr: torch.Tensor,
                        packed: Optional[dict] = None) -> torch.Tensor:
    """The features x that enter hr_conv0's x-part, with the trunk kernel
    (the int8 head's calibration probe: x depends on lr alone)."""
    return _x_features(G, lr, kernel_trunk_fn(G, packed))
