"""Served fields, made from the seed with numpy alone (the HTTP clients run
in processes of their own that never touch the card).

A field is one hour of analytic flow over smooth terrain on terrain-
following levels: a streamfunction's divergence-free (u, v) with a log-law
shear, a terrain-induced w, small noise. The model inputs are the
normalised (u, v, w) decimated to the LR grid plus the normalised height
channel, and the raw heights at the HR grid; the normalisation is fixed
(uvw over 20 m/s, heights over 0..1000 m), so every field of every seed is
on one scale.
"""

from __future__ import annotations

import numpy as np

GRID_SPACING = 150.0
UVW_MAX = 20.0
Z_MIN, Z_MAX = 0.0, 1000.0


def terrain(nx: int, ny: int) -> np.ndarray:
    x = np.linspace(0, 2 * np.pi, nx)
    y = np.linspace(0, 2 * np.pi, ny)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    t = (120.0 * (1 + np.sin(1.3 * xx) * np.cos(0.9 * yy + 0.7))
         + 30.0 * np.sin(2.7 * xx + 1.1) * np.sin(2.2 * yy))
    return np.maximum(t - t.min(), 0.0)


def field(rng: np.random.Generator, nx: int, ny: int, nz: int, scale: int):
    """One field: (lr (nx/s, ny/s, nz, 4), z (nx, ny, nz, 1)) float32."""
    ter = terrain(nx, ny)
    xx, yy = np.meshgrid(np.arange(nx) * GRID_SPACING,
                         np.arange(ny) * GRID_SPACING, indexing="ij")
    sigma = np.linspace(0.0, 1.0, nz + 1)[1:] ** 1.3
    zag = sigma[None, None, :] * (600.0 - 0.4 * ter[:, :, None])
    z = zag + ter[:, :, None]
    amp = rng.uniform(4.0, 14.0)
    a = rng.uniform(900.0, 2600.0)
    ph = rng.uniform(0, 2 * np.pi, size=4)
    psi_y = (np.cos(xx / a + ph[0]) * np.cos(yy / a + ph[1])
             + 0.5 * np.cos(2.3 * yy / a + ph[2]))
    psi_x = (-np.sin(xx / a + ph[0]) * np.sin(yy / a + ph[1])
             + 0.4 * np.sin(1.7 * xx / a + ph[3]))
    shear = np.log1p(zag / 2.0) / np.log1p(600.0 / 2.0)
    u = amp * psi_y[:, :, None] * shear + rng.normal(0, 0.15, zag.shape)
    v = -amp * psi_x[:, :, None] * shear + rng.normal(0, 0.15, zag.shape)
    w = (0.15 * (np.gradient(ter, GRID_SPACING, axis=0) * amp * psi_y
                 - np.gradient(ter, GRID_SPACING, axis=1) * amp * psi_x
                 )[:, :, None] * np.exp(-zag / 200.0)
         + rng.normal(0, 0.05, zag.shape))
    uvw = np.stack([u, v, w], -1) / UVW_MAX
    zc = ((z - Z_MIN) / (Z_MAX - Z_MIN))[..., None]
    lr = np.concatenate([uvw, zc], -1)[::scale, ::scale]
    return lr.astype(np.float32), z[..., None].astype(np.float32)


def pool(seed: int, n: int, nx: int, ny: int, nz: int, scale: int):
    """``n`` distinct fields from ``seed``: (lr (n, ...), z (n, ...))."""
    rng = np.random.default_rng([int(seed), 7])
    pairs = [field(rng, nx, ny, nz, scale) for _ in range(n)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def arrivals(seed: int, rate: float, seconds: float,
             trace_seed: int) -> np.ndarray:
    """The due times of a window of ``seconds`` at ``rate``: one Poisson
    trace, the same for every seed, entered at a gap the seed draws.

    The trace is ``round(rate * seconds)`` exponential gaps drawn from
    ``trace_seed`` and scaled to span the window (a Poisson process's
    arrivals given their count), so a second holds as many arrivals as a
    Poisson stream's would; it is read cyclically from the seed's gap, so
    every seed offers the same gaps and bursts, at other times."""
    n = int(round(float(rate) * float(seconds)))
    gaps = np.random.default_rng([int(trace_seed), 11]).exponential(1.0, n)
    gaps *= float(seconds) / gaps.sum()
    k = int(np.random.default_rng([int(seed), 11]).integers(n))
    gaps = np.roll(gaps, -k)
    return np.cumsum(gaps) - gaps[0]
