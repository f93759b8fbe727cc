"""Physics-informed differential operators on nonuniform 3D grids.

Counterpart of ``gan_sr_wind_field_tpu/ops/physics.py``, plain PyTorch,
channels-last ``(N, X, Y, Z, C)``:

- horizontal gradients are second-order nonuniform central differences with
  one-sided first-order boundaries (``torch.gradient`` with coordinates);
- the vertical gradient is the dZ²-weighted nonuniform stencil on the
  terrain-following grid, one-sided at the boundaries;
- the loss normalisation factors are ``max(HR_max, SR_max / 100)``; the
  z-gradient factor is a signed max (no abs), a reference quirk kept here.

Everything is computed in float32 whatever the input dtype: the stencils
cancel, and bf16 would destroy the divergence signal. All functions are
differentiable with autograd. ``gradient_on_slab`` runs a gradient on this
rank's x slab of a spatial axis, widened by one neighbour plane each side.
"""

from __future__ import annotations

import torch

from gan_sr_wind_field_tpu_torch.parallel.collectives import group_amax
from gan_sr_wind_field_tpu_torch.parallel.halo import x_window


def _nonuniform_gradient_1d(f: torch.Tensor, coords: torch.Tensor,
                            axis: int) -> torch.Tensor:
    """Second-order nonuniform central difference along ``axis`` of f,
    one-sided first-order at both ends; ``coords`` are the axis's
    physical coordinates."""
    if f.shape[axis] < 2:
        raise ValueError("gradient needs at least 2 points")
    f = f.movedim(axis, -1)
    h = coords[1:] - coords[:-1]
    hs, hd = h[:-1], h[1:]  # left and right spacing of interior points
    interior = (hs ** 2 * f[..., 2:] + (hd ** 2 - hs ** 2) * f[..., 1:-1]
                - hd ** 2 * f[..., :-2]) / (hs * hd * (hs + hd))
    left = (f[..., 1:2] - f[..., 0:1]) / h[0]
    right = (f[..., -1:] - f[..., -2:-1]) / h[-1]
    return torch.cat([left, interior, right], dim=-1).movedim(-1, axis)


def gradient_xy(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """∂field/∂x and ∂field/∂y of ``field`` (N, X, Y, Z, C) for the
    coordinate vectors x (X,) and y (Y,)."""
    return (_nonuniform_gradient_1d(field, x, axis=1),
            _nonuniform_gradient_1d(field, y, axis=2))


def gradient_z_nonuniform(field: torch.Tensor, Z: torch.Tensor):
    """∂field/∂z on the terrain-following grid; ``field`` (N, X, Y, Zl, C),
    ``Z`` (N, X, Y, Zl, 1) heights. The reference's ``calculate_div_z``."""
    dZ = Z[:, :, :, 1:] - Z[:, :, :, :-1]
    d_lo, d_hi = dZ[:, :, :, :-1], dZ[:, :, :, 1:]
    interior = (d_lo ** 2 * field[:, :, :, 2:]
                + (d_hi ** 2 - d_lo ** 2) * field[:, :, :, 1:-1]
                - d_hi ** 2 * field[:, :, :, :-2]) / (d_lo * d_hi
                                                      * (d_lo + d_hi))
    bottom = (field[:, :, :, 1:2] - field[:, :, :, 0:1]) / dZ[:, :, :, 0:1]
    top = (field[:, :, :, -1:] - field[:, :, :, -2:-1]) / dZ[:, :, :, -1:]
    return torch.cat([bottom, interior, top], dim=3)


def wind_field_gradient(uvw: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        Z: torch.Tensor) -> torch.Tensor:
    """9-channel gradient [∂(u,v,w)/∂x, ∂(u,v,w)/∂y, ∂(u,v,w)/∂z] of
    ``uvw`` (N, X, Y, Zl, 3), float32; divergence = ch0 + ch4 + ch8."""
    uvw = uvw.float()
    gx, gy = gradient_xy(uvw, x.float(), y.float())
    gz = gradient_z_nonuniform(uvw, Z.float())
    return torch.cat([gx, gy, gz], dim=-1)


def gradient_on_slab(gradient, uvw: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, z_window, slab) -> torch.Tensor:
    """``gradient(uvw, x, y, Z)`` (``wind_field_gradient`` or the stencil
    kernel's ``WindFieldGradient.apply``) of this rank's x slab ``uvw`` of
    a spatial axis (``parallel/halo.py``): the slab is widened by one plane
    from each neighbour (none at the volume's ends), the gradient runs on
    it with its x coordinates ``x[a−1 : b+1]``, and the halo's outputs are
    dropped. Exact: the x derivative at an edge plane reads one neighbour
    plane, and only the volume's two ends are one-sided. ``z_window`` is
    ``x_window(Z, slab)[0]``, the heights widened the same way (taken once
    for every gradient of a step). In the backward the halo's cotangents
    go back to the neighbours."""
    w = uvw.shape[1]
    wide, lo = x_window(uvw, slab)
    a = slab.index * w - lo
    g = gradient(wide, x[a:a + wide.shape[1]], y, z_window)
    return g[:, lo:lo + w]


def divergence_3d(grad9: torch.Tensor) -> torch.Tensor:
    """∇·u from a 9-channel gradient: ch0 + ch4 + ch8."""
    return grad9[..., 0] + grad9[..., 4] + grad9[..., 8]


def divergence_xy(grad9: torch.Tensor) -> torch.Tensor:
    """Horizontal divergence: ch0 + ch4."""
    return grad9[..., 0] + grad9[..., 4]


def gradient_norm_factors(hr_grad: torch.Tensor, sr_grad: torch.Tensor,
                          group=None):
    """(xy-gradient, z-gradient, divergence, xy-divergence) factors, each
    max(HR_max, SR_max / 100); the z factor is a signed max. With a
    process ``group`` (the mesh's ranks) the maxima are over every rank's
    rows and slabs (``parallel/collectives.py:group_amax``)."""
    def amax(t):
        return torch.amax(t) if group is None else group_amax(t, group)

    def both(f):
        return torch.maximum(amax(f(hr_grad)), amax(f(sr_grad)) / 100.0)

    return (
        both(lambda g: g[..., :6].abs()),
        both(lambda g: g[..., 6:]),
        both(lambda g: divergence_3d(g).abs()),
        both(lambda g: divergence_xy(g).abs()),
    )
