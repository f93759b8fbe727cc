"""PyTorch port: Discriminator3D, its blocks and batch norm, and the
discriminator half of the weight bridge, against the JAX package on the
CPU.

Weights and batch statistics go through the bridge; inputs are numpy
seeds; float32. Tolerance 1e-5 of the largest value: the convolutions and
the batch-statistic means sum in a different order on the two sides.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.models import Discriminator3D as FlaxD
from gan_sr_wind_field_tpu.models.discriminator import (
    remainder_z_layers as jax_remainder_z_layers,
)
from gan_sr_wind_field_tpu_torch.models.discriminator import (
    Discriminator3D,
    remainder_z_layers,
)
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    d_params_to_jax,
)

# (enable_slicing, spatial, z layers): the sliced head at a 16² patch, and
# the five-block body at 32² (it halves x and y five times)
GEOMS = [(True, 16, 4), (False, 32, 4)]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@functools.lru_cache(maxsize=None)
def _flax_init(slicing, size, zl):
    D = FlaxD(base_features=4, number_of_z_layers=zl, enable_slicing=slicing)
    x0 = np.zeros((2, size, size, zl, 3), np.float32)
    return D.init(jax.random.key(0), x0, train=False)


def _pair(slicing, size, zl, dropout=0.0, seed=0):
    kw = dict(base_features=4, number_of_z_layers=zl, enable_slicing=slicing,
              dropout_probability=dropout)
    D = FlaxD(**kw)
    var = _flax_init(slicing, size, zl)
    params = jax.tree.map(np.asarray, var["params"])
    stats = jax.tree.map(np.asarray, var["batch_stats"])
    # non-trivial norm parameters and running statistics
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, params)
    stats = jax.tree.map(
        lambda a: np.abs(a + 0.1 * rng.standard_normal(a.shape)
                         ).astype(np.float32), stats)
    Dt = Discriminator3D(spatial=(size, size), **kw)
    Dt.load_state_dict(d_params_from_jax(params, stats), strict=True)
    x = rng.standard_normal((2, size, size, zl, 3)).astype(np.float32)
    return D, params, stats, Dt, x


def test_remainder_z_layers_matches_jax():
    for zl in (4, 10, 19, 20, 33):
        assert remainder_z_layers(zl) == jax_remainder_z_layers(zl)


@pytest.mark.parametrize("slicing,size,zl", GEOMS)
def test_bridge_round_trip(slicing, size, zl):
    _, params, stats, Dt, _ = _pair(slicing, size, zl)
    back_p, back_s = d_params_to_jax(Dt.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        want = jax.tree_util.tree_leaves_with_path(tree)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf)


@pytest.mark.parametrize("slicing,size,zl", GEOMS)
def test_eval_forward_and_features_match_jax(slicing, size, zl):
    D, params, stats, Dt, x = _pair(slicing, size, zl, seed=1)
    var = {"params": params, "batch_stats": stats}
    got = Dt(torch.from_numpy(x), train=False)
    assert got.shape == (2,) and got.dtype == torch.float32
    _close(got.detach().numpy(), D.apply(var, x, train=False))
    feats = Dt(torch.from_numpy(x), train=False, features_only=True)
    _close(feats.detach().numpy(),
           D.apply(var, x, train=False, features_only=True))


@pytest.mark.parametrize("slicing,size,zl", GEOMS)
def test_train_forward_and_two_stat_updates_match_jax(slicing, size, zl):
    """Two train-mode forwards in sequence, as a D step runs them: logits
    from batch statistics, dropout masks from JAX's keys, and the running
    statistics after both updates (flax keeps the biased variance)."""
    D, params, stats, Dt, x = _pair(slicing, size, zl, dropout=0.2, seed=2)
    x2 = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)
    bs = stats
    for i, xin in enumerate((x, x2)):
        key = jax.random.key(10 + i)
        want, mut = D.apply({"params": params, "batch_stats": bs}, xin,
                            train=True, rng_key=key,
                            mutable=["batch_stats"])
        bs = mut["batch_stats"]
        keep = np.array(jax.random.bernoulli(key, 0.8, (2, 1, 1, 1, 32)))
        got = Dt(torch.from_numpy(xin), train=True, update_stats=True,
                 dropout_mask=torch.from_numpy(keep))
        _close(got.detach().numpy(), want)
    want_stats = d_params_from_jax({}, jax.tree.map(np.asarray, bs))
    got_stats = dict(Dt.named_buffers())
    assert set(want_stats) == set(got_stats)
    for k, v in want_stats.items():
        _close(got_stats[k].numpy(), v.numpy())


def test_train_forward_without_update_keeps_statistics():
    _, _, _, Dt, x = _pair(True, 16, 4, seed=3)
    before = {k: v.clone() for k, v in Dt.named_buffers()}
    Dt(torch.from_numpy(x), train=True, update_stats=False)
    for k, v in Dt.named_buffers():
        assert torch.equal(v, before[k])
