"""Serving API for a trained generator, on the CUDA card by default.

    sr = WindFieldSR.from_continuation(cfg, "docs/evidence/milestone9k_continuation_9000.npz")
    sr = WindFieldSR.from_checkpoint(cfg, "runs/<run>/ckpt_6016", x, y)
    hr_uvw = sr.upscale(lr_field, z_terrain)        # model (normalized) space
    hr_ms = sr.upscale_physical(lr_uvw_ms, z_raw)   # m/s in, m/s out

Counterpart of ``gan_sr_wind_field_tpu/eval/serve.py:WindFieldSR``. The
forward runs the RRDB trunk as the trunk kernel (``models/fused_apply.py``)
whenever the geometry allows it (3D convs, 1×1×1 LFF), and hr_conv0 as the
HR-head kernel (``ops/hr_head.py``) when the configuration sets
``use_pallas_head`` or ``use_pallas_head_nograd`` beside
``use_fused_trunk``: serving is a forward without a gradient. On a CUDA
device the constructor builds the kernels it will launch, so the first
request pays no build.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.transform import (
    _stat,
    lr_channel_names,
    physical_to_model_inputs,
)
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.fused_apply import (
    generate_fused,
    head_kernel_flags,
)
from gan_sr_wind_field_tpu_torch.models.generator import generator_from_config
from gan_sr_wind_field_tpu_torch.ops.hr_head import pack_head_weights
from gan_sr_wind_field_tpu_torch.ops.kernels import build
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    trunk_fusable,
)
from gan_sr_wind_field_tpu_torch.train.checkpoint import load_generator_state
from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax


class WindFieldSR:
    def __init__(self, cfg, params, device=None, norm_stats=None):
        """``params``: a port ``Generator3D`` state_dict (see
        ``utils/jax_params.py`` for weights from the JAX package).
        ``norm_stats``: the training data's normalization factors (a
        ``NormStats``-like object or dict), needed by ``upscale_physical``.
        """
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scale = cfg.scale
        self.norm_stats = norm_stats
        g = cfg.gan_config
        self.lr_channels = lr_channel_names(
            g.include_pressure, g.include_z_channel,
            g.include_above_ground_channel,
        )
        self.G = generator_from_config(cfg, device=self.device)
        self.G.load_state_dict(params, strict=True)
        G = self.G
        self.packed = None
        if trunk_fusable(G.num_rdb_convs, G.lff_kern_size, G.conv_mode):
            self.packed = pack_trunk_weights(G.rrdbs, G.dtype, self.device)
        self.head_packed = None
        if (self.packed is not None and head_kernel_flags(cfg)[1]
                and G.negative_slope > 0):
            self.head_packed = pack_head_weights(
                G.hr_conv0_x.weight, G.hr_conv0_t.weight, G.dtype,
                self.device)
        if self.device.type == "cuda":
            build.warm((["rdb_trunk"] if self.packed is not None else [])
                       + (["hr_head"] if self.head_packed is not None
                          else []))

    @classmethod
    def from_continuation(cls, cfg, path: str, use_ema: bool = True,
                          device=None, norm_stats=None):
        """Serve the generator weights of a continuation pack; the EMA slot
        is preferred when the pack has one and ``use_ema``."""
        pack = load_continuation(path)
        tree = pack["params_G_ema"] if use_ema else None
        if tree is None:
            tree = pack["params_G"]
        return cls(cfg, params_from_jax(tree), device=device,
                   norm_stats=norm_stats)

    @classmethod
    def from_checkpoint(cls, cfg, path: str, x, y, use_ema: bool = True,
                        device=None, norm_stats=None):
        """Serve a trained generator: a port checkpoint folder
        (``ckpt_{it}``), or a continuation pack (a path ending ``.npz``,
        see ``from_continuation``). The EMA slot is preferred when there
        is one and ``use_ema``. ``x``/``y`` are the training grid's
        coordinates, as ``WindFieldGAN`` takes them.

        The checkpoint's weights are restored into a state built at the
        training patch (D's classifier depends on it; G on no size), on
        ``device``, whatever device saved it. A reference ``.pth`` raises:
        ``utils/torch_import.py`` is not ported."""
        if path.endswith(".npz"):
            return cls.from_continuation(cfg, path, use_ema=use_ema,
                                         device=device, norm_stats=norm_stats)
        state = load_generator_state(
            cfg, WindFieldGAN(cfg, x, y, device=device), path)
        params = state.params_G_ema if use_ema else None
        if params is None:
            params = state.params_G
        return cls(cfg, params, device=device, norm_stats=norm_stats)

    @torch.inference_mode()
    def _generate(self, lr: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if self.packed is None:
            return self.G(lr, z)
        return generate_fused(self.G, lr, z, self.packed, self.head_packed,
                              head=self.head_packed is not None)

    def upscale(self, lr, z_terrain) -> np.ndarray:
        """lr: (x, y, zl, C) or batched; returns (X, Y, zl, 3) float32."""
        lr = np.asarray(lr, np.float32)
        z_terrain = np.asarray(z_terrain, np.float32)
        squeeze = lr.ndim == 4
        if squeeze:
            lr, z_terrain = lr[None], z_terrain[None]
        out = self._generate(torch.from_numpy(lr).to(self.device),
                             torch.from_numpy(z_terrain).to(self.device))
        out = out.cpu().numpy()
        return out[0] if squeeze else out

    def upscale_physical(self, lr_uvw, z, pressure=None,
                         z_above_ground=None) -> np.ndarray:
        """Physical units: LR wind in m/s and raw HR height ``z`` in, SR
        wind in m/s out, normalized with this instance's ``norm_stats``."""
        if self.norm_stats is None:
            raise ValueError(
                "physical-units serving needs norm_stats (pass the "
                "training dataset's stats to WindFieldSR)"
            )
        g = self.cfg.gan_config
        lr, zt = physical_to_model_inputs(
            lr_uvw, z, self.norm_stats, self.scale,
            include_pressure=g.include_pressure,
            include_z_channel=g.include_z_channel,
            include_above_ground_channel=g.include_above_ground_channel,
            pressure=pressure, z_above_ground=z_above_ground,
        )
        return self.upscale(lr, zt) * _stat(self.norm_stats, "uvw_max")
