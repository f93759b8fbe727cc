"""Device-resident training data: upload the split's full volumes once and
cut every batch on the device.

Counterpart of ``gan_sr_wind_field_tpu/data/device_data.py``. The whole
training split fits the card (192 volumes of 128×128×10 with 4 LR channels
and the raw heights are 629 MB), so it is uploaded once and each batch is a
gather on the card: no host→device traffic per step.

The per-sample math is the host path's (``WindDataset.get``): patches at
Beta(0.25, 0.25) corner-biased HR offsets, HR = channels 0–2 of the patch,
LR = the strided decimation of the patch (every LR channel is a pointwise
normalization, so normalizing then decimating commutes, and one full-grid
``reformat_sample(coarseness_factor=1)`` per volume carries every channel).
Samples are drawn uniformly with replacement over the split, as in the JAX
package. The draws come from a ``torch.Generator``, not ``jax.random``: the
streams differ from the JAX package's, the distributions do not.
``slice_batch_with`` takes the draws as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.transform import reformat_sample

# Jöhnk's Beta(a, a) sampler takes this many candidates per sample in one
# draw; at a = 0.25 each is accepted with probability 0.927, so a sample
# lacks an accepted one with probability 0.073^8 ≈ 8e-10 (then it draws
# again)
_BETA_CANDIDATES = 8


def beta_draws(n: int, a: float, generator: torch.Generator, device=None):
    """n draws of Beta(a, a) (float64) from ``generator`` by Jöhnk's
    method: U^(1/a) / (U^(1/a) + V^(1/a)) over pairs of uniforms with
    U^(1/a) + V^(1/a) <= 1."""
    device = generator.device if device is None else device
    out = torch.full((n,), float("nan"), dtype=torch.float64, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while True:
        uv = torch.rand((2, n, _BETA_CANDIDATES), generator=generator,
                        dtype=torch.float64, device=device) ** (1.0 / a)
        s = uv[0] + uv[1]
        ok = (s <= 1.0) & (s > 0.0)
        first = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)
        cand = (uv[0] / s).gather(1, first)[:, 0]
        take = todo & ok.any(dim=1)
        out = torch.where(take, cand, out)
        todo = todo & ~take
        if not bool(todo.any()):
            return out


def slice_draws(n_volumes: int, batch_size: int, X: int, Y: int,
                patch: int, patch_y: int, enable_slicing: bool,
                generator: torch.Generator, device=None):
    """One batch's draws: volume indices uniform over the split, then the
    x and y offsets of each patch (zero without slicing)."""
    device = generator.device if device is None else device
    idx = torch.randint(0, n_volumes, (batch_size,), generator=generator,
                        device=device)
    if not enable_slicing:
        zero = torch.zeros(batch_size, dtype=torch.int64, device=device)
        return idx, zero, zero
    xs = torch.round(beta_draws(batch_size, 0.25, generator, device)
                     * (X - patch)).to(torch.int64)
    ys = torch.round(beta_draws(batch_size, 0.25, generator, device)
                     * (Y - patch_y)).to(torch.int64)
    return idx, xs, ys


def slice_batch_with(full, zraw, idx, xs, ys, *, patch: int, patch_y: int,
                     cf: int):
    """The batch for given draws. full: (N, X, Y, ZL, C), every LR channel
    at the full HR grid; zraw: (N, X, Y, ZL, 1) raw heights. → (LR, HR, Z)
    exactly as the host path makes them for the same patches."""
    ax = torch.arange(patch, device=full.device)
    ay = torch.arange(patch_y, device=full.device)
    i = idx[:, None, None]
    gx = (xs[:, None] + ax[None, :])[:, :, None]
    gy = (ys[:, None] + ay[None, :])[:, None, :]
    patch_b = full[i, gx, gy]
    hr = patch_b[..., :3].contiguous()
    lr = patch_b[:, ::cf, ::cf].contiguous()
    return lr, hr, zraw[i, gx, gy].contiguous()


def slice_batch(full, zraw, generator: torch.Generator, *, batch_size: int,
                patch: int, patch_y: int, cf: int, enable_slicing: bool):
    """One batch over the resident volumes with draws from ``generator``."""
    N, X, Y = full.shape[:3]
    draws = slice_draws(N, batch_size, X, Y, patch, patch_y, enable_slicing,
                        generator, full.device)
    return slice_batch_with(full, zraw, *draws, patch=patch, patch_y=patch_y,
                            cf=cf)


def load_resident_volumes(dataset):
    """The split's full volumes for ``slice_batch`` (host side).

    → (full (N,X,Y,ZL,C) f32, zraw (N,X,Y,ZL,1) f32) numpy arrays."""
    full, zraw = [], []
    for name in dataset.filenames:
        z, zag, u, v, w, p = dataset._load(name)
        if dataset.interpolate_z:
            z, zag, u, v, w, p = dataset._interp_cached(
                name, z, zag, u, v, w, p
            )
        # cf=1: LR == all channels at the full HR grid (u,v,w then the
        # extra LR channels); channel-wise normalize/decimate commute
        lr1, _, zt = reformat_sample(
            np.asarray(z), np.asarray(zag), np.asarray(u),
            np.asarray(v), np.asarray(w), np.asarray(p),
            dataset.stats, coarseness_factor=1,
            include_pressure=dataset.include_pressure,
            include_z_channel=dataset.include_z_channel,
            include_above_ground_channel=(
                dataset.include_above_ground_channel
            ),
        )
        full.append(lr1)
        zraw.append(zt)
    return np.stack(full), np.stack(zraw)


def batch_seed(seed: int, count: int) -> int:
    """The generator seed of batch ``count`` of the stream ``seed``."""
    return (int(seed) << 32) + int(count)


class DeviceBatcher:
    """Infinite iterator of (LR, HR, Z) training batches on ``device``.

    The dataset's volumes are uploaded once (its slicing and augmentation
    flags are not used: patches are cut here, augmentation belongs to the
    step). Batch ``count`` draws from a generator seeded with
    ``batch_seed(seed, count)``; the count starts at ``start_count``, so a
    resumed leg that passes its iteration continues the stream instead of
    replaying it.
    """

    def __init__(self, dataset, batch_size: int, device, seed: int = 0,
                 start_count: int = 0):
        self.batch_size = int(batch_size)
        self.slice_size = int(dataset.slice_size)
        self.enable_slicing = bool(dataset.enable_slicing)
        self.cf = int(dataset.coarseness_factor)
        self.device = torch.device(device)
        self.seed = int(seed)
        self.count = int(start_count)

        full, zraw = load_resident_volumes(dataset)
        self.full = torch.from_numpy(full).to(self.device)
        self.zraw = torch.from_numpy(zraw).to(self.device)
        X, Y = full.shape[1:3]
        self.patch = self.slice_size if self.enable_slicing else X
        self.patch_y = self.slice_size if self.enable_slicing else Y
        self._gen = torch.Generator(device=self.device)

    def resident_bytes(self) -> int:
        return (self.full.numel() * self.full.element_size()
                + self.zraw.numel() * self.zraw.element_size())

    def __iter__(self):
        return self

    def __next__(self):
        self._gen.manual_seed(batch_seed(self.seed, self.count))
        self.count += 1
        return slice_batch(self.full, self.zraw, self._gen,
                           batch_size=self.batch_size, patch=self.patch,
                           patch_y=self.patch_y, cf=self.cf,
                           enable_slicing=self.enable_slicing)
