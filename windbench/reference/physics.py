"""Plain float32 physics operators of the reference: the 9-channel wind
gradient on the terrain-following grid (second-order nonuniform central
differences inside, first-order one-sided at the ends) and the divergences.
"""

from __future__ import annotations

import torch


def _nonuniform_1d(f, coords, axis: int):
    f = f.movedim(axis, -1)
    h = coords[1:] - coords[:-1]
    hs, hd = h[:-1], h[1:]
    interior = (hs ** 2 * f[..., 2:] + (hd ** 2 - hs ** 2) * f[..., 1:-1]
                - hd ** 2 * f[..., :-2]) / (hs * hd * (hs + hd))
    left = (f[..., 1:2] - f[..., 0:1]) / h[0]
    right = (f[..., -1:] - f[..., -2:-1]) / h[-1]
    return torch.cat([left, interior, right], dim=-1).movedim(-1, axis)


def _gradient_z(f, Z):
    dZ = Z[:, :, :, 1:] - Z[:, :, :, :-1]
    lo, hi = dZ[:, :, :, :-1], dZ[:, :, :, 1:]
    interior = (lo ** 2 * f[:, :, :, 2:]
                + (hi ** 2 - lo ** 2) * f[:, :, :, 1:-1]
                - hi ** 2 * f[:, :, :, :-2]) / (lo * hi * (lo + hi))
    bottom = (f[:, :, :, 1:2] - f[:, :, :, 0:1]) / dZ[:, :, :, 0:1]
    top = (f[:, :, :, -1:] - f[:, :, :, -2:-1]) / dZ[:, :, :, -1:]
    return torch.cat([bottom, interior, top], dim=3)


def wind_gradient(uvw, x, y, Z):
    """[d(u,v,w)/dx, d(u,v,w)/dy, d(u,v,w)/dz] of uvw (N, X, Y, Zl, 3)."""
    uvw = uvw.float()
    return torch.cat([_nonuniform_1d(uvw, x.float(), 1),
                      _nonuniform_1d(uvw, y.float(), 2),
                      _gradient_z(uvw, Z.float())], dim=-1)


def div3(g9):
    return g9[..., 0] + g9[..., 4] + g9[..., 8]


def div_xy(g9):
    return g9[..., 0] + g9[..., 4]
