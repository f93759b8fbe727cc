"""Serving API for a trained generator, on the CUDA card by default.

    sr = WindFieldSR.from_continuation(cfg, "docs/evidence/milestone9k_continuation_9000.npz")
    hr_uvw = sr.upscale(lr_field, z_terrain)        # model (normalized) space
    hr_ms = sr.upscale_physical(lr_uvw_ms, z_raw)   # m/s in, m/s out

Counterpart of ``gan_sr_wind_field_tpu/eval/serve.py:WindFieldSR``. The
forward runs the RRDB trunk as the trunk kernel (``models/fused_apply.py``)
whenever the geometry allows it (3D convs, 1×1×1 LFF).
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
from gan_sr_wind_field_tpu_torch.models.fused_apply import generate_fused
from gan_sr_wind_field_tpu_torch.models.generator import generator_from_config
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    trunk_fusable,
)
from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
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
        self.packed = None
        if trunk_fusable(self.G.num_rdb_convs, self.G.lff_kern_size,
                         self.G.conv_mode):
            self.packed = pack_trunk_weights(self.G.rrdbs, self.G.dtype,
                                             self.device)

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

    @torch.inference_mode()
    def _generate(self, lr: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if self.packed is None:
            return self.G(lr, z)
        return generate_fused(self.G, lr, z, self.packed)

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
