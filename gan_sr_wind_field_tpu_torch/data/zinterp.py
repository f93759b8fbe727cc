"""Vertical (z-axis) regridding between terrain-following and regular grids
(the port's own copy of ``gan_sr_wind_field_tpu/data/zinterp.py``).

The HARMONIE-SIMRA samples live on terrain-following z-levels (each column's
physical heights differ). The reference optionally regrids u,v,w,p onto one
shared regular ``z_above_ground`` linspace with per-column ``np.interp``
loops (download_data.py:320-357) and maps predictions back to the raw grid
for test metrics (download_data.py:301-317).

This module reimplements both directions with a *vectorized* batched linear
interpolation (`_interp_columns`) — no Python per-column loops — exactly
matching ``np.interp`` semantics (constant extrapolation at both ends).
"""

from __future__ import annotations

import numpy as np


def _interp_columns(x_new: np.ndarray, x_old: np.ndarray, y_old: np.ndarray):
    """Per-column linear interpolation, vectorized over leading dims.

    All inputs (..., nz); every column of x_old/x_new must be ascending.
    Equivalent to ``np.interp(x_new[c], x_old[c], y_old[c])`` per column c.
    """
    shape = x_new.shape
    xn = np.asarray(x_new, np.float64).reshape(-1, shape[-1])
    xo = np.asarray(x_old, np.float64).reshape(-1, x_old.shape[-1])
    yo = np.asarray(y_old, np.float64).reshape(-1, y_old.shape[-1])
    nz_old = xo.shape[-1]

    out = np.empty_like(xn)
    # chunk the columns: the O(nz²) interval search below builds a
    # (chunk, nz, nz) comparison tensor — chunking bounds it to a few MB
    # regardless of horizontal extent
    chunk = max(1, 4_000_000 // (nz_old * xn.shape[-1] * 8))
    for c0 in range(0, xn.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        xnc, xoc, yoc = xn[sl], xo[sl], yo[sl]
        # index of the interval: number of old knots <= new point
        cnt = (xoc[:, None, :] <= xnc[:, :, None]).sum(axis=-1)
        hi = np.clip(cnt, 1, nz_old - 1)
        lo = hi - 1
        x_lo = np.take_along_axis(xoc, lo, 1)
        x_hi = np.take_along_axis(xoc, hi, 1)
        y_lo = np.take_along_axis(yoc, lo, 1)
        y_hi = np.take_along_axis(yoc, hi, 1)
        t = (xnc - x_lo) / (x_hi - x_lo)
        o = y_lo + t * (y_hi - y_lo)
        # np.interp boundary semantics: clamp to end values
        o = np.where(xnc <= xoc[:, :1], yoc[:, :1], o)
        o = np.where(xnc >= xoc[:, -1:], yoc[:, -1:], o)
        out[sl] = o
    return out.reshape(shape)


def interpolate_z_columns(x, y, z_above_ground, u, v, w, p, terrain):
    """Regrid one sample onto a shared regular z_above_ground grid.

    The new 1D grid spans mean(bottom level)..mean(top level) with the same
    number of levels (reference download_data.py:330-335).

    → (z, z_above_ground, u, v, w, p) on the new grid; z_above_ground is
    identical for every column, z = z_above_ground + terrain.
    """
    nz = z_above_ground.shape[-1]
    new_1d = np.linspace(
        float(np.mean(z_above_ground[:, :, 0])),
        float(np.mean(z_above_ground[:, :, -1])),
        num=nz,
    )
    zag_new = np.broadcast_to(new_1d, z_above_ground.shape).copy()
    u_i = _interp_columns(zag_new, z_above_ground, u)
    v_i = _interp_columns(zag_new, z_above_ground, v)
    w_i = _interp_columns(zag_new, z_above_ground, w)
    p_i = _interp_columns(zag_new, z_above_ground, p)
    z_new = zag_new + np.asarray(terrain)[:, :, None]
    return z_new, zag_new, u_i, v_i, w_i, p_i


def reverse_interpolate_z_columns(field, z_raw, z_interp):
    """Map a field on the regular grid back to the raw per-column levels.

    field, z_interp: (..., nz) on the regular grid; z_raw: target per-column
    heights. → field sampled at z_raw (reference download_data.py:301-317).
    """
    return _interp_columns(
        np.asarray(z_raw, np.float64),
        np.asarray(z_interp, np.float64),
        np.asarray(field, np.float64),
    ).astype(np.float32)
