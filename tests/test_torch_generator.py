"""PyTorch port: the generator forward against the JAX package.

The port's ``generate_fused`` (trunk through ``rrdb_trunk``, which takes
the plain version for CPU tensors) and its module forward against JAX
``generate_fused(interpret=True)`` and ``Generator3D.apply(train=False)``,
with the same flax weights carried over by the bridge. Float32; tolerance
1e-5 (convolution sums run in a different order).
"""

import jax
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.models import Generator3D as FlaxGenerator3D
from gan_sr_wind_field_tpu.models.fused_apply import (
    generate_fused as jax_generate_fused,
)
from gan_sr_wind_field_tpu_torch.models.fused_apply import generate_fused
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax

TINY = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=2,
            upscale=4, hr_kern_size=3, rdb_growth_channels=4,
            lff_kern_size=1, terrain_features=4)


def _inputs(seed, lr_shape=(2, 4, 4, 3, 4), scale=4):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal(lr_shape).astype(np.float32)
    z = rng.standard_normal(
        (lr_shape[0], lr_shape[1] * scale, lr_shape[2] * scale,
         lr_shape[3], 1)).astype(np.float32)
    return lr, z


def _pair(num_convs, lr, z, init_scale=0.5, seed=0, **kw):
    cfg = dict(TINY, **kw)
    Gj = FlaxGenerator3D(num_rdb_convs=num_convs, init_scale=init_scale,
                         dropout_probability=0.0, **cfg)
    params = Gj.init(jax.random.key(seed), lr, z, train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    Gt = Generator3D(num_rdb_convs=num_convs, **cfg)
    Gt.load_state_dict(params_from_jax(params), strict=True)
    return Gj, params, Gt.eval()


@pytest.mark.parametrize("num_convs", [3, 5])
def test_generate_fused_matches_jax(num_convs):
    lr, z = _inputs(num_convs)
    Gj, params, Gt = _pair(num_convs, lr, z, seed=num_convs)
    want_fused = np.asarray(jax_generate_fused(Gj, params, lr, z,
                                               interpret=True))
    want_apply = np.asarray(Gj.apply({"params": params}, lr, z, train=False))
    with torch.no_grad():
        got = generate_fused(Gt, torch.from_numpy(lr), torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3, 3)
    np.testing.assert_allclose(got.numpy(), want_fused, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_apply, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_convs", [3, 5])
def test_module_forward_matches_flax_apply(num_convs):
    lr, z = _inputs(20 + num_convs)
    Gj, params, Gt = _pair(num_convs, lr, z, seed=20 + num_convs)
    want = np.asarray(Gj.apply({"params": params}, lr, z, train=False))
    with torch.no_grad():
        got = Gt(torch.from_numpy(lr), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_upscale_16x_and_odd_geometry():
    """A 16x chain (four upconvs) on a non-square LR with odd z."""
    lr, z = _inputs(7, lr_shape=(1, 2, 3, 5, 4), scale=16)
    Gj, params, Gt = _pair(5, lr, z, seed=7, upscale=16, num_rrdb=1)
    want = np.asarray(jax_generate_fused(Gj, params, lr, z, interpret=True))
    with torch.no_grad():
        got = generate_fused(Gt, torch.from_numpy(lr), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_upsample_nearest_xy_matches_jax():
    from gan_sr_wind_field_tpu.ops.resize import (
        upsample_nearest_xy as jax_upsample,
    )

    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5, 6)).astype(
        np.float32)
    got = upsample_nearest_xy(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_upsample(x, 2)))


def test_horizontal_conv_mode_is_not_ported():
    """horizontal_3D is ported now (tests/test_torch_horizontal.py holds
    it against JAX): it needs the z extent for its window counts, builds
    6-D kernels with one unsplit hr_conv0 and a bias-free hr_conv1, keeps
    the LFF a shared 3D conv, and refuses the trunk kernel's path."""
    with pytest.raises(ValueError, match="z extent"):
        Generator3D(conv_mode="horizontal_3D", **TINY)
    G = Generator3D(conv_mode="horizontal_3D", z_layers=3, **TINY)
    assert G.feature_conv.weight.shape == (3, 8, 4, 3, 3, 3)
    assert G.hr_conv0.weight.shape == (3, 12, 12, 3, 3, 3)
    assert G.hr_conv1.bias is None
    assert G.rrdbs[0].rdbs[0].lff.weight.dim() == 5
    lr, z = _inputs(0)
    out = G(torch.from_numpy(lr), torch.from_numpy(z))
    assert out.shape == (2, 16, 16, 3, 3)
    with pytest.raises(ValueError, match="horizontal_3D"):
        generate_fused(G, torch.from_numpy(lr), torch.from_numpy(z))
