"""Generator3D — RRDB ESRGAN-3D super-resolution generator.

Counterpart of ``gan_sr_wind_field_tpu/models/generator.py:Generator3D``:

    LR (N, x, y, zl, C_in)
      → feature_conv → skip(num_rrdb × RRDB → lr_conv)
      → ⌊log2(scale)⌋ × [nearest ×(2,2,1) upsample → conv3 → lrelu]
    Z (N, X, Y, zl, 1) → conv3 + lrelu → conv3
    conv_mode "3D":            lrelu(hr_conv0_x(x) + hr_conv0_t(t))
                               → hr_conv1 (+ bias) → 3 channels
    conv_mode "horizontal_3D": lrelu(hr_conv0(cat(x, t)))
                               → hr_conv1 (no bias) → 3 channels

In 3D mode hr_conv0 is split by input channel, as the JAX package's
``split_hr_concat`` computes it (the same function). In horizontal mode
every conv but the RDBs' LFF is a per-z-window conv
(``models/blocks.py:horizontal_conv3d_cl``), hr_conv0 is one unsplit conv
and hr_conv1 has no bias, as in JAX (``generator.py:191-220``); the
window counts need the z extent ``z_layers``, and the trunk and head
kernels do not apply. Channel dropout (``dropout_probability``) after
lrelu(hr_conv0) acts only with ``train=True``. Parameters are float32;
``dtype`` is the compute dtype. The output is float32. On the spatial axis
of a mesh (``forward(slab=)``) the inputs and the output are this rank's x
slabs and every conv takes its x halo (``models/blocks.py``); the kernels
and int8 do not apply there, as JAX's ``dp_only`` rule keeps them off. On
the model axis (``shard_channels``) each conv whose leaves JAX shards
computes this rank's output channels and gathers the rest; the forward is
the modules', and its inputs and output are whole on every model rank.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.blocks import ConvLReLU, RRDB
from gan_sr_wind_field_tpu_torch.models.fused_apply import (
    generator_forward,
    int8_trunk_fn,
    kernel_head_fn,
)
from gan_sr_wind_field_tpu_torch.models.fused_train import trainable_trunk_fn


class Generator3D(nn.Module):
    def __init__(self, in_channels: int = 4, out_channels: int = 3,
                 num_features: int = 128, num_rrdb: int = 16,
                 upscale: int = 4, hr_kern_size: int = 5,
                 num_rdb_convs: int = 5, rdb_growth_channels: int = 32,
                 lff_kern_size: int = 1, rdb_residual_scaling: float = 0.2,
                 rrdb_residual_scaling: float = 0.2,
                 negative_slope: float = 0.2, terrain_features: int = 16,
                 dropout_probability: float = 0.0, init_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32, conv_mode: str = "3D",
                 z_layers: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = num_features
        self.out_channels = out_channels
        self.num_features = nf
        self.num_rrdb = num_rrdb
        self.upscale = upscale
        self.hr_kern_size = hr_kern_size
        self.num_rdb_convs = num_rdb_convs
        self.rdb_growth_channels = rdb_growth_channels
        self.lff_kern_size = lff_kern_size
        self.rdb_residual_scaling = rdb_residual_scaling
        self.rrdb_residual_scaling = rrdb_residual_scaling
        self.negative_slope = negative_slope
        self.dropout_probability = dropout_probability
        self.conv_mode = conv_mode
        self.dtype = dtype
        self.channels = None  # set by shard_channels

        # every conv here keeps the z extent, so one z_in serves them all
        kw = dict(init_scale=init_scale, dtype=dtype, conv_mode=conv_mode,
                  z_in=z_layers, generator=generator)
        lrelu_kw = dict(negative_slope=negative_slope, **kw)
        self.feature_conv = ConvLReLU(in_channels, nf, lrelu=False, **kw)
        self.rrdbs = nn.ModuleList(
            RRDB(nf, rdb_growth_channels, num_convs=num_rdb_convs,
                 lff_kern_size=lff_kern_size,
                 rdb_residual_scaling=rdb_residual_scaling,
                 rrdb_residual_scaling=rrdb_residual_scaling, **lrelu_kw)
            for _ in range(num_rrdb)
        )
        self.lr_conv = ConvLReLU(nf, nf, lrelu=False, **kw)
        self.upconvs = nn.ModuleList(
            ConvLReLU(nf, nf, **lrelu_kw)
            for _ in range(int(math.floor(math.log2(upscale))))
        )
        self.terrain_conv0 = ConvLReLU(1, terrain_features, **lrelu_kw)
        self.terrain_conv1 = ConvLReLU(terrain_features, terrain_features,
                                       lrelu=False, **kw)
        hr_feats = nf + terrain_features
        self.hr_features = hr_feats  # hr_conv0's channels (the dropout's)
        hp = (hr_kern_size - 1) // 2
        hr_kw = dict(kernel_size=hr_kern_size, padding=hp, lrelu=False, **kw)
        if conv_mode == "3D":
            self.hr_conv0_x = ConvLReLU(nf, hr_feats, **hr_kw)
            self.hr_conv0_t = ConvLReLU(terrain_features, hr_feats, **hr_kw)
        else:
            self.hr_conv0 = ConvLReLU(hr_feats, hr_feats, **hr_kw)
        # use_bias is dropped by a horizontal conv, as in JAX
        self.hr_conv1 = ConvLReLU(hr_feats, out_channels, use_bias=True,
                                  **hr_kw)

    def shard_channels(self, channels, keys=frozenset()) -> None:
        """Run each conv whose weight's key is in ``keys`` on this rank's
        output channels (``channels``, ``parallel/model.py``), given as
        its weight and bias, and gather its output; ``None`` turns every
        conv back to whole weights."""
        self.channels = channels if keys else None
        for name, m in self.named_modules():
            if isinstance(m, ConvLReLU):
                m.channels = (channels if f"{name}.weight" in keys
                              else None)

    def trunk(self, x: torch.Tensor, slab=None) -> torch.Tensor:
        """The RRDB chain, module by module (the plain path); on a
        ``slab`` each conv takes its x halo."""
        for rrdb in self.rrdbs:
            x = rrdb(x, slab)
        return x

    def forward(self, lr: torch.Tensor, z_terrain: torch.Tensor, *,
                train: bool = False, trunk: str = "modules",
                head: str = "modules",
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                qhead=None, qtrunk=None, slab=None):
        """lr: (N, x, y, zl, C_in); z_terrain: (N, x·s, y·s, zl, 1).
        ``trunk`` picks how the RRDB trunk runs: "modules" (the RRDB
        modules, autograd through them) or "kernel" (the trunk kernels,
        ``models/fused_train.py:trainable_trunk_fn``: with its backward
        kernel where a gradient is needed, one launch without residuals
        where not). ``head`` picks how hr_conv0 and the channel dropout
        run: "modules" or "kernel" (the HR-head kernel,
        ``models/fused_apply.py:kernel_head_fn``). ``train`` turns on
        channel dropout, with ``dropout_mask`` or drawn from
        ``generator``. Serving's calibrated int8 replaces the trunk
        (``qtrunk``, whatever ``trunk`` says) and hr_conv0's x-part
        (``qhead``, which turns the head kernel off). In horizontal mode
        the kernels and int8 raise ValueError, as JAX's ``trunk_fusable``
        needs "3D", and so do they on a ``slab`` (this rank's x slab on a
        spatial axis, ``parallel/halo.py``) and with ``shard_channels``
        set, where the modules run."""
        if trunk not in ("modules", "kernel"):
            raise ValueError(f"unknown trunk {trunk!r}")
        if head not in ("modules", "kernel"):
            raise ValueError(f"unknown head {head!r}")
        if self.conv_mode != "3D" and (
                trunk == "kernel" or head == "kernel"
                or qhead is not None or qtrunk is not None):
            raise ValueError(f"conv_mode={self.conv_mode!r} runs the "
                             "modules only: the trunk and head kernels and "
                             "int8 need '3D'")
        if (slab is not None or self.channels is not None) and (
                trunk != "modules" or head != "modules"
                or qhead is not None or qtrunk is not None):
            raise ValueError("a slab of the spatial axis or a share of the "
                             "model axis runs the modules only: the kernels "
                             "and int8 take whole volumes and weights")
        if qtrunk is not None:
            trunk_fn = int8_trunk_fn(self, qtrunk)
        elif trunk == "modules":
            trunk_fn = functools.partial(self.trunk, slab=slab)
        else:
            trunk_fn = trainable_trunk_fn(self)
        use_head = head == "kernel" and qhead is None
        return generator_forward(
            self, lr, z_terrain, trunk_fn, train=train,
            dropout_mask=dropout_mask, generator=generator,
            head_fn=kernel_head_fn(self) if use_head else None, qhead=qhead,
            slab=slab)


def _act_slope(act_type: str) -> float:
    """Config act_type → LeakyReLU slope ('relu' is slope 0; anything
    else falls back to leakyrelu(0.2) with a warning)."""
    act = (act_type or "leakyrelu").lower()
    if act == "relu":
        return 0.0
    if act != "leakyrelu":
        import logging

        logging.getLogger("status").warning(
            f"activation type {act_type} not implemented - "
            "defaulting to leaky ReLU (0.2)"
        )
    return 0.2


def generator_from_config(cfg, device=None, seed: int = 0) -> Generator3D:
    """The config's generator in eval mode on ``device`` (default ``cuda``),
    weights drawn from ``seed`` at the config's ``weight_init_scale``
    (mirrors ``WindFieldGAN.__init__``,
    gan_sr_wind_field_tpu/train/gan.py:113-132)."""
    dev = resolve_device(device)
    return build_generator(cfg, seed).to(dev).eval()


def empty_generator(cfg, device=None) -> Generator3D:
    """The config's generator on ``device`` (default ``cuda``) with its
    weights allocated but not drawn, for a caller that loads them or
    passes its own (``load_state_dict``, ``functional_call``): drawing
    weights that are overwritten takes seconds on the host at the
    horizontal_3D width (3.3e8 parameters). They hold NaN until then, so
    a forward on them shows."""
    with torch.device("meta"):
        G = build_generator(cfg)
    G = G.to_empty(device=resolve_device(device))
    with torch.no_grad():
        for p in G.parameters():
            p.fill_(float("nan"))
    return G


def build_generator(cfg, seed: int = 0) -> Generator3D:
    """The config's generator on the CPU, weights drawn from ``seed``."""
    g = cfg.generator
    return Generator3D(
        in_channels=cfg.lr_num_channels,
        out_channels=g.out_num_ch,
        num_features=g.num_features,
        num_rrdb=g.num_RRDB,
        upscale=cfg.scale,
        hr_kern_size=g.hr_kern_size,
        num_rdb_convs=g.num_RDB_convs,
        rdb_growth_channels=g.RDB_growth_chan,
        lff_kern_size=g.lff_kern_size,
        rdb_residual_scaling=g.RDB_res_scaling,
        rrdb_residual_scaling=g.RRDB_res_scaling,
        terrain_features=g.terrain_number_of_features,
        dropout_probability=g.dropout_probability,
        init_scale=g.weight_init_scale,
        dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32),
        conv_mode=cfg.gan_config.conv_mode,
        z_layers=cfg.gan_config.number_of_z_layers,
        negative_slope=_act_slope(g.act_type),
        generator=torch.Generator().manual_seed(seed),
    )
