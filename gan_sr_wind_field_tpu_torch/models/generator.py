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
from dataclasses import dataclass
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
from gan_sr_wind_field_tpu_torch.ops.hr_head import HEAD_TILES, plan_head_tc
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import trunk_fusable


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
    # each tensor allocated anew on the device (Module.to_empty goes through
    # torch's Python references of the meta device, which import sympy:
    # seconds at start)
    dev = resolve_device(device)
    for mod in G.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                mod._parameters[name] = nn.Parameter(
                    torch.full(p.shape, float("nan"), dtype=p.dtype,
                               device=dev), requires_grad=p.requires_grad)
        for name, b in mod._buffers.items():
            if b is not None:
                mod._buffers[name] = torch.empty(b.shape, dtype=b.dtype,
                                                 device=dev)
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


@dataclass(frozen=True)
class HeadChoice:
    """How hr_conv0, its LeakyReLU and the channel dropout run: ``train``
    in G forwards with a gradient, ``nograd`` in those without (D steps,
    validation, ``generate``, serving), each "kernel" (the HR-head kernel,
    ``ops/hr_head.py``) or "modules"; ``why`` says why, for the status
    log."""
    train: str
    nograd: str
    why: str

    def status(self) -> str:
        """The status log's line."""
        if self.train == self.nograd:
            return f"HR head: {self.train} ({self.why})"
        return (f"HR head: {self.train} with a gradient, {self.nograd} "
                f"without ({self.why})")


def choose_head(cfg, device, mesh=None) -> HeadChoice:
    """How the configuration's G runs its head on ``device`` (a mesh's
    spatial or model axis runs the modules).

    The kernel rides on the trunk kernels, as in the JAX package: it needs
    ``use_fused_trunk``, a trunk geometry they take (``trunk_fusable``:
    conv_mode "3D"), a LeakyReLU slope > 0 (its backward reads the slope's
    side from its output) and no spatial or model axis. On a CUDA device
    in bfloat16 the kernel then runs every forward, with and without a
    gradient, wherever its tensor-core tile computes the head (kernel
    size 3 or 5, the HR depth ``number_of_z_layers`` within the tile's
    shared memory, ``plan_head_tc``), and the modules elsewhere. The two
    head flags are the JAX package's TPU scheduling knobs; they route the
    head where there is no tensor-core tile, on the CPU (whose "kernel" is
    the plain version) and in float32: ``use_pallas_head`` sets both
    paths, ``use_pallas_head_nograd`` the forwards without a gradient."""
    g, gen = cfg.gan_config, cfg.generator
    if mesh is not None and (mesh.spatial > 1 or mesh.model > 1):
        return HeadChoice("modules", "modules",
                          "a spatial or model axis: one launch cannot take "
                          "a halo or a channel gather")
    if not getattr(cfg, "use_fused_trunk", False):
        return HeadChoice("modules", "modules", "use_fused_trunk is off")
    if not trunk_fusable(gen.num_RDB_convs, gen.lff_kern_size, g.conv_mode):
        return HeadChoice("modules", "modules",
                          f"conv_mode {g.conv_mode!r}: the trunk kernels do "
                          "not take this geometry")
    if not _act_slope(gen.act_type) > 0:
        return HeadChoice("modules", "modules", "a LeakyReLU slope of 0")
    k = gen.hr_kern_size
    on_card = torch.device(device).type == "cuda"
    if on_card and cfg.compute_dtype == "bfloat16":
        if k not in HEAD_TILES:
            return HeadChoice("modules", "modules",
                              f"hr_kern_size {k}: the tensor-core tiles "
                              f"take {sorted(HEAD_TILES)}")
        nf, tc = gen.num_features, gen.terrain_number_of_features
        zl = g.number_of_z_layers
        try:
            plan_head_tc((1, 1, 1, zl), nf, tc, nf + tc, k)
        except ValueError as e:
            return HeadChoice("modules", "modules", str(e))
        return HeadChoice("kernel", "kernel",
                          f"bf16 tensor-core tile, k = {k}, Zl = {zl}")
    both = bool(getattr(cfg, "use_pallas_head", False))
    nograd = both or bool(getattr(cfg, "use_pallas_head_nograd", False))
    where = (f"{cfg.compute_dtype} (the tensor-core tile is bf16)"
             if on_card else f"device {device}")
    return HeadChoice("kernel" if both else "modules",
                      "kernel" if nograd else "modules",
                      f"{where}: the head flags route it")
