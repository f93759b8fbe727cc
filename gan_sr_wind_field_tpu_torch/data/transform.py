"""Sample → (LR, HR, Z) formatting and normalization, both halves.

The port's own copy of ``gan_sr_wind_field_tpu/data/transform.py`` (numpy
only): the training half (``NormStats``, ``reformat_sample``) and the
serving half (``lr_channel_names``, ``_stat``, ``physical_to_model_inputs``).
Channel-last layout; z is never coarsened, only x and y.

- HR  = stack(u, v, w)/UVW_MAX                         → (nx, ny, nz, 3)
- LR  = HR decimated ``[::cf, ::cf, :]`` (pure striding, not filtered, as
  the reference does), plus optional channels: pressure (min-max), z or
  (z_above_ground, z_relative) (min-max)
- Z   = raw geopotential height                        → (nx, ny, nz, 1)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NormStats:
    """Aggregated train-split normalization factors
    (reference process_data.py:327,360-366)."""

    z_min: float
    z_max: float
    z_above_ground_max: float
    uvw_max: float
    p_min: float
    p_max: float


def reformat_sample(
    z: np.ndarray,
    z_above_ground: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    p: np.ndarray,
    stats: NormStats,
    coarseness_factor: int = 4,
    include_pressure: bool = False,
    include_z_channel: bool = False,
    include_above_ground_channel: bool = False,
    for_plotting: bool = False,
):
    """→ (LR, HR, Z) float32 channel-last arrays.

    ``for_plotting`` appends the normalized pressure as a 4th HR channel
    (reference process_data.py:446-450, used by the offline plots)."""
    cf = coarseness_factor
    hr = np.stack([u, v, w], axis=-1) / stats.uvw_max
    if for_plotting and include_pressure:
        hr = np.concatenate(
            [
                hr,
                ((p - stats.p_min) / (stats.p_max - stats.p_min))[..., None],
            ],
            axis=-1,
        )

    channels = [hr[::cf, ::cf, :, :3]]
    if include_pressure:
        channels.append(
            ((p - stats.p_min) / (stats.p_max - stats.p_min))[
                ::cf, ::cf, :, None
            ]
        )
    if include_z_channel:
        if include_above_ground_channel:
            channels.append(
                (z_above_ground / stats.z_above_ground_max)[::cf, ::cf, :, None]
            )
            channels.append(
                (
                    (z - z_above_ground - stats.z_min)
                    / (stats.z_max - stats.z_min - stats.z_above_ground_max)
                )[::cf, ::cf, :, None]
            )
        else:
            channels.append(
                ((z - stats.z_min) / (stats.z_max - stats.z_min))[
                    ::cf, ::cf, :, None
                ]
            )

    lr = np.concatenate(channels, axis=-1) if len(channels) > 1 else channels[0]
    return (
        np.ascontiguousarray(lr, dtype=np.float32),
        np.ascontiguousarray(hr, dtype=np.float32),
        np.ascontiguousarray(z[..., None], dtype=np.float32),
    )


def _stat(stats, name: str) -> float:
    """NormStats attribute or dict key (artifact headers carry dicts)."""
    if isinstance(stats, dict):
        return float(stats[name])
    return float(getattr(stats, name))


def lr_channel_names(include_pressure: bool, include_z_channel: bool,
                     include_above_ground_channel: bool) -> list:
    """The LR channel layout ``reformat_sample`` produces, by name —
    serialized into export artifacts so they stay self-describing."""
    names = ["u", "v", "w"]
    if include_pressure:
        names.append("p")
    if include_z_channel:
        if include_above_ground_channel:
            names += ["z_above_ground", "z_relative"]
        else:
            names.append("z")
    return names


def physical_to_model_inputs(
    lr_uvw: np.ndarray,
    z: np.ndarray,
    stats,
    scale: int,
    include_pressure: bool = False,
    include_z_channel: bool = False,
    include_above_ground_channel: bool = False,
    pressure: np.ndarray = None,
    z_above_ground: np.ndarray = None,
):
    """Raw physical-unit fields → the generator's normalized (lr, z) pair.

    The serving-side inverse of ``reformat_sample``'s LR construction
    (same normalization factors and channel order), except the wind is
    already at LR resolution and the z channels decimate the HR terrain.

    lr_uvw: (…, x, y, zl, 3) wind in m/s; z: (…, X, Y, zl) or (…, X, Y,
    zl, 1) raw geopotential height at HR resolution (X = x·scale);
    pressure: (…, x, y, zl) in Pa, required iff ``include_pressure``;
    z_above_ground: (…, X, Y, zl), required iff
    ``include_above_ground_channel``.  Leading batch dims pass through.
    Returns (lr, z_terrain) float32 model inputs.
    """
    s = int(scale)
    lr_uvw = np.asarray(lr_uvw, np.float32)
    z = np.asarray(z, np.float32)
    if z.shape[-1] == 1 and z.ndim == lr_uvw.ndim:
        z = z[..., 0]
    channels = [lr_uvw / _stat(stats, "uvw_max")]
    if include_pressure:
        if pressure is None:
            raise ValueError("this model's LR input includes pressure")
        p = np.asarray(pressure, np.float32)
        p_min, p_max = _stat(stats, "p_min"), _stat(stats, "p_max")
        channels.append(((p - p_min) / (p_max - p_min))[..., None])
    if include_z_channel:
        z_min, z_max = _stat(stats, "z_min"), _stat(stats, "z_max")
        z_lr = z[..., ::s, ::s, :]
        if include_above_ground_channel:
            if z_above_ground is None:
                raise ValueError(
                    "this model's LR input includes z_above_ground"
                )
            zag_max = _stat(stats, "z_above_ground_max")
            zag_lr = np.asarray(z_above_ground, np.float32)[..., ::s, ::s, :]
            channels.append((zag_lr / zag_max)[..., None])
            channels.append(
                ((z_lr - zag_lr - z_min) / (z_max - z_min - zag_max))[
                    ..., None
                ]
            )
        else:
            channels.append(((z_lr - z_min) / (z_max - z_min))[..., None])
    lr = (np.concatenate(channels, axis=-1) if len(channels) > 1
          else channels[0])
    return (
        np.ascontiguousarray(lr, np.float32),
        np.ascontiguousarray(z[..., None], np.float32),
    )
