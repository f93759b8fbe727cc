"""Equivariant data augmentation for 3D wind vector fields.

The port's own copy of ``gan_sr_wind_field_tpu/data/augment.py``. The wind
field is a vector field: a spatial rot90 or flip must also transform the
(u, v) components, or the physics (divergence-freeness) breaks.

Semantics (channel-last (X, Y, Z, C); components u = ch0, v = ch1):

- rot90 by k in the (x, y) plane: spatial ``rot90(axes=(0, 1))`` then
  (u, v) → k=1: (-v, u); k=2: (-u, -v); k=3: (v, -u).
- flip along x (axis 0): spatial flip + u → -u; along y: v → -v.
- the geopotential-height field Z and any scalar LR channels (pressure,
  z-channels) transform spatially only.

Two implementations with the same semantics:

- numpy per sample (the host dataset path, explicit ``np.random.Generator``);
- torch batched (``augment_batch``), used inside the train step on the
  card: plain tensor ops, each sample with its own draws (k, fx, fy) from
  an explicit ``torch.Generator``. ``augment_batch_with`` takes the draws
  as tensors. Both are permutations and sign flips, so they are exact.
"""

from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------
# numpy (host) versions
# --------------------------------------------------------------------------


def rot90_vector_field_np(a: np.ndarray, k: int, rotate_uv: bool = True):
    """Rotate (X,Y,Z,C) by k·90° in the xy-plane with (u,v) rotation."""
    k = k % 4
    out = np.rot90(a, k, axes=(0, 1)).copy()
    if rotate_uv and k and a.shape[-1] >= 2:
        u = out[..., 0].copy()
        v = out[..., 1].copy()
        if k == 1:
            out[..., 0], out[..., 1] = -v, u
        elif k == 2:
            out[..., 0], out[..., 1] = -u, -v
        else:
            out[..., 0], out[..., 1] = v, -u
    return out


def flip_vector_field_np(a: np.ndarray, axis: int, negate: bool = True):
    """Mirror along spatial ``axis`` (0=x, 1=y), negating that component."""
    out = np.flip(a, axis=axis).copy()
    if negate and a.shape[-1] > axis:
        out[..., axis] = -out[..., axis]
    return out


def augment_sample_np(lr, hr, z, rng: np.random.Generator,
                      rot: bool = True, flip: bool = True):
    """Host-side augmentation of one (LR, HR, Z) triple.

    Draw order mirrors the reference's __getitem__ (rot int, then two
    uniform flips — process_data.py:198-262) so a fixed seed reproduces.
    """
    if rot:
        k = int(rng.integers(0, 4))
        lr = rot90_vector_field_np(lr, k)
        hr = rot90_vector_field_np(hr, k)
        z = np.rot90(z, k, axes=(0, 1)).copy()
    if flip:
        if rng.random() > 0.5:
            lr = flip_vector_field_np(lr, 0)
            hr = flip_vector_field_np(hr, 0)
            z = np.flip(z, axis=0).copy()
        if rng.random() > 0.5:
            lr = flip_vector_field_np(lr, 1)
            hr = flip_vector_field_np(hr, 1)
            z = np.flip(z, axis=1).copy()
    return lr, hr, z


# --------------------------------------------------------------------------
# torch (device) versions
# --------------------------------------------------------------------------


def augment_draws(n: int, generator: torch.Generator, device=None):
    """One batch's draws: k (n,) int64 in {0..3}, then fx and fy (n,)
    bools, each true with probability 0.5."""
    device = generator.device if device is None else device
    k = torch.randint(0, 4, (n,), generator=generator, device=device)
    fx = torch.rand(n, generator=generator, device=device) < 0.5
    fy = torch.rand(n, generator=generator, device=device) < 0.5
    return k, fx, fy


def _mix_uv(r: torch.Tensor, k: int) -> torch.Tensor:
    u, v = r[..., 0], r[..., 1]
    mixed = {1: (-v, u), 2: (-u, -v), 3: (v, -u)}[k]
    return torch.cat([torch.stack(mixed, -1), r[..., 2:]], -1)


def _per_sample(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (a.dim() - 1))


def _transform(x: torch.Tensor, k, fx, fy, vector: bool) -> torch.Tensor:
    """Rotate each sample of (N, X, Y, Z, C) by its k·90° (X = Y), then
    mirror it along x where fx and along y where fy; with ``vector`` the
    (u, v) channels are mixed and negated with it."""
    out = x
    for kk in (1, 2, 3):
        r = torch.rot90(x, kk, dims=(1, 2))
        if vector and x.shape[-1] >= 2:
            r = _mix_uv(r, kk)
        out = torch.where(_per_sample(k == kk, x), r, out)
    for axis, f in ((1, fx), (2, fy)):
        m = torch.flip(out, dims=(axis,))
        c = axis - 1  # u for x, v for y
        if vector and x.shape[-1] > c:
            m = torch.cat([m[..., :c], -m[..., c:c + 1], m[..., c + 1:]], -1)
        out = torch.where(_per_sample(f, x), m, out)
    return out


def augment_batch_with(lr, hr, z, k, fx, fy):
    """The same spatial transform per sample to lr (N,x,y,zl,C), hr
    (N,X,Y,zl,3) and z (N,X,Y,zl,1), given the draws; lr and hr get the
    component mixing, z does not."""
    return (_transform(lr, k, fx, fy, True), _transform(hr, k, fx, fy, True),
            _transform(z, k, fx, fy, False))


def augment_batch(generator: torch.Generator, lr, hr, z):
    """Batched augmentation: independent rot90 and flips per sample, drawn
    from ``generator`` (``augment_draws``)."""
    return augment_batch_with(lr, hr, z,
                              *augment_draws(lr.shape[0], generator,
                                             lr.device))
