"""PyTorch port: the RRDB trunk (plain version and kernel wrapper) against
the JAX package's fused Pallas trunk, run in interpret mode on the CPU.

Same inputs (numpy seeds) and the same flax weights, carried over by the
weight bridge; comparisons in float32. Tolerance 1e-5: the convolutions
sum in a different order on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.models import Generator3D as FlaxGenerator3D
from gan_sr_wind_field_tpu.ops.pallas.rdb_trunk import (
    fused_rrdb_trunk,
    pack_trunk_params,
)
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D
from gan_sr_wind_field_tpu_torch.ops import rdb_trunk
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    rrdb_trunk,
    rrdb_trunk_reference,
    trunk_fusable,
)
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax

TINY = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=2,
            upscale=4, hr_kern_size=3, rdb_growth_channels=4,
            lff_kern_size=1, terrain_features=4)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _flax_params(num_convs, init_scale, seed=0, lr_shape=(2, 4, 4, 3, 4)):
    G = FlaxGenerator3D(num_rdb_convs=num_convs, init_scale=init_scale,
                        dropout_probability=0.0, **TINY)
    lr = np.zeros(lr_shape, np.float32)
    z = np.zeros((lr_shape[0], lr_shape[1] * 4, lr_shape[2] * 4,
                  lr_shape[3], 1), np.float32)
    params = G.init(jax.random.key(seed), lr, z, train=False)["params"]
    return G, jax.tree.map(np.asarray, params)


def _port_generator(num_convs, params):
    G = Generator3D(num_rdb_convs=num_convs, **TINY)
    G.load_state_dict(params_from_jax(params), strict=True)
    return G.eval()


@pytest.mark.parametrize("num_convs", [3, 5])
def test_reference_matches_jax_fused_trunk(num_convs):
    """Weights at init scale 1.0 so the ×0.2 residuals do not hide the
    growth convs; the increment trunk(x) - x is compared too."""
    G, params = _flax_params(num_convs, init_scale=1.0, seed=num_convs)
    x = np.random.default_rng(num_convs).standard_normal(
        (2, 4, 4, 3, 8)).astype(np.float32)

    packed_j = pack_trunk_params(params, G.num_rrdb, num_convs,
                                 G.num_features, G.rdb_growth_channels,
                                 jnp.float32)
    want = np.asarray(fused_rrdb_trunk(
        packed_j, jnp.asarray(x), gc=G.rdb_growth_channels,
        num_convs=num_convs, interpret=True,
    ))

    Gt = _port_generator(num_convs, params)
    packed = pack_trunk_weights(Gt.rrdbs, torch.float32)
    got = rrdb_trunk_reference(packed, torch.from_numpy(x), gc=4,
                               num_convs=num_convs).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel_l2(got - x, want - x) < 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_convs", [3, 5])
def test_reference_matches_module_chain(num_convs):
    """The packed plain trunk equals the port's RRDB modules run in order."""
    _, params = _flax_params(num_convs, init_scale=1.0, seed=10 + num_convs)
    Gt = _port_generator(num_convs, params)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 3, 5, 8)).astype(np.float32))
    with torch.no_grad():
        want = Gt.trunk(x)
    got = rrdb_trunk_reference(pack_trunk_weights(Gt.rrdbs, torch.float32),
                               x, gc=4, num_convs=num_convs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    _, params = _flax_params(3, init_scale=1.0)
    Gt = _port_generator(3, params)
    packed = pack_trunk_weights(Gt.rrdbs, torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 4, 3, 8)).astype(np.float32))
    before = rdb_trunk.launches
    got = rrdb_trunk(packed, x, gc=4, num_convs=3)
    assert rdb_trunk.launches == before  # no kernel launched on the CPU
    torch.testing.assert_close(
        got, rrdb_trunk_reference(packed, x, gc=4, num_convs=3),
        rtol=0, atol=0,
    )


def test_bf16_reference_rounds_like_jax_kernel():
    """bfloat16 storage: plain version and the JAX kernel (interpret) agree
    to bf16 resolution on the trunk increment."""
    G, params = _flax_params(3, init_scale=1.0, seed=4)
    x = np.random.default_rng(9).standard_normal(
        (1, 4, 4, 3, 8)).astype(np.float32)
    packed_j = pack_trunk_params(params, G.num_rrdb, 3, G.num_features,
                                 G.rdb_growth_channels, jnp.bfloat16)
    want = np.asarray(fused_rrdb_trunk(
        packed_j, jnp.asarray(x, jnp.bfloat16), gc=4, num_convs=3,
        interpret=True,
    ).astype(jnp.float32))
    Gt = _port_generator(3, params)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = rrdb_trunk_reference(pack_trunk_weights(Gt.rrdbs, torch.bfloat16),
                               xt, gc=4, num_convs=3)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    x16 = xt.float().numpy()
    assert _rel_l2(got - x16, want - x16) < 3e-2


def test_wrapper_rejects_mismatched_pack():
    _, params = _flax_params(3, init_scale=1.0)
    packed = pack_trunk_weights(_port_generator(3, params).rrdbs,
                                torch.float32)
    x = torch.zeros(1, 4, 4, 3, 8)
    with pytest.raises(ValueError):
        rrdb_trunk(packed, x, gc=4, num_convs=5)  # wrong geometry
    with pytest.raises(ValueError):
        rrdb_trunk(packed, x.to(torch.bfloat16), gc=4, num_convs=3)
    with pytest.raises(ValueError):
        rrdb_trunk(packed, x, gc=4, num_convs=3, rdbs_per_rrdb=4)


def test_trunk_fusable_has_no_row_cap():
    assert trunk_fusable(5, 1, "3D")
    assert trunk_fusable(2, 1, "3D")
    assert not trunk_fusable(5, 3, "3D")
    assert not trunk_fusable(5, 1, "horizontal_3D")
    assert not trunk_fusable(1, 1, "3D")
