"""Generator3D — RRDB ESRGAN-3D super-resolution generator.

Counterpart of ``gan_sr_wind_field_tpu/models/generator.py:Generator3D``
with ``conv_mode="3D"``, the split ``hr_conv0_x``/``hr_conv0_t`` and a
biased ``hr_conv1``:

    LR (N, x, y, zl, C_in)
      → feature_conv → skip(num_rrdb × RRDB → lr_conv)
      → ⌊log2(scale)⌋ × [nearest ×(2,2,1) upsample → conv3 → lrelu]
    Z (N, X, Y, zl, 1) → conv3 + lrelu → conv3
    lrelu(hr_conv0_x(x) + hr_conv0_t(t)) → hr_conv1 (+ bias) → 3 channels

Channel dropout (``dropout_probability``) after lrelu(hr_conv0) acts only
with ``train=True``. Parameters are float32; ``dtype`` is the compute
dtype. The output is float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.blocks import ConvLReLU, RRDB
from gan_sr_wind_field_tpu_torch.models.fused_apply import (
    generator_forward,
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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = num_features
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

        kw = dict(init_scale=init_scale, dtype=dtype, conv_mode=conv_mode,
                  generator=generator)
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
        hp = (hr_kern_size - 1) // 2
        hr_kw = dict(kernel_size=hr_kern_size, padding=hp, lrelu=False, **kw)
        self.hr_conv0_x = ConvLReLU(nf, hr_feats, **hr_kw)
        self.hr_conv0_t = ConvLReLU(terrain_features, hr_feats, **hr_kw)
        self.hr_conv1 = ConvLReLU(hr_feats, out_channels, use_bias=True,
                                  **hr_kw)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The RRDB chain, module by module (the plain path)."""
        for rrdb in self.rrdbs:
            x = rrdb(x)
        return x

    def forward(self, lr: torch.Tensor, z_terrain: torch.Tensor, *,
                train: bool = False, trunk: str = "modules",
                head: str = "modules",
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """lr: (N, x, y, zl, C_in); z_terrain: (N, x·s, y·s, zl, 1).
        ``trunk`` picks how the RRDB trunk runs: "modules" (the RRDB
        modules, autograd through them) or "kernel" (the trunk kernels,
        ``models/fused_train.py:trainable_trunk_fn``: with its backward
        kernel where a gradient is needed, one launch without residuals
        where not). ``head`` picks how hr_conv0 and the channel dropout
        run: "modules" or "kernel" (the HR-head kernel,
        ``models/fused_apply.py:kernel_head_fn``). ``train`` turns on
        channel dropout, with ``dropout_mask`` or drawn from
        ``generator``."""
        if trunk == "modules":
            trunk_fn = self.trunk
        elif trunk == "kernel":
            trunk_fn = trainable_trunk_fn(self)
        else:
            raise ValueError(f"unknown trunk {trunk!r}")
        if head not in ("modules", "kernel"):
            raise ValueError(f"unknown head {head!r}")
        return generator_forward(
            self, lr, z_terrain, trunk_fn, train=train,
            dropout_mask=dropout_mask, generator=generator,
            head_fn=kernel_head_fn(self) if head == "kernel" else None)


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
        negative_slope=_act_slope(g.act_type),
        generator=torch.Generator().manual_seed(seed),
    )
