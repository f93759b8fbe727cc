"""PyTorch port: the trunk's residual mode and backward (plain versions),
the trainable trunk and the training forward of the generator, against the
JAX package on the CPU (Pallas kernels in interpret mode).

Weights go through the bridge, inputs are numpy seeds. Tolerances:
float32 to 1e-5 of the largest value where only the order of the float32
sums differs; bfloat16 to 2e-2 relative L2 (the rounding points are the
JAX kernel's, but a one-ulp difference in an early RDB carries through the
later ones); gradients to rtol 2e-4 / atol 2e-5 of the largest entry, as
tests/test_fused_train.py compares the JAX trunk VJP with autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.models import Generator3D as FlaxGenerator3D
from gan_sr_wind_field_tpu.models.fused_train import (
    apply_trainable as jax_apply_trainable,
)
from gan_sr_wind_field_tpu.ops.pallas.rdb_trunk import (
    fused_rrdb_trunk,
    fused_rrdb_trunk_bwd,
    pack_trunk_params,
    pack_trunk_params_bwd,
)
from gan_sr_wind_field_tpu_torch.models.fused_train import (
    TrainableTrunk,
    apply_trainable,
)
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D
from gan_sr_wind_field_tpu_torch.ops import rdb_trunk
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
    pack_trunk_weights,
    pack_trunk_weights_bwd,
    rrdb_trunk,
    rrdb_trunk_bwd,
    rrdb_trunk_reference,
)
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax

TINY = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=2,
            upscale=4, hr_kern_size=3, rdb_growth_channels=4,
            lff_kern_size=1, terrain_features=4)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _setup(num_convs, seed, init_scale=1.0, dropout=0.0):
    G = FlaxGenerator3D(num_rdb_convs=num_convs, init_scale=init_scale,
                        dropout_probability=dropout, **TINY)
    lr = np.zeros((2, 4, 4, 3, 4), np.float32)
    z = np.zeros((2, 16, 16, 3, 1), np.float32)
    params = jax.tree.map(np.asarray, G.init(jax.random.key(seed), lr, z,
                                             train=False)["params"])
    Gt = Generator3D(num_rdb_convs=num_convs, dropout_probability=dropout,
                     **TINY)
    Gt.load_state_dict(params_from_jax(params), strict=True)
    return G, params, Gt


def _check(got, want, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert _rel_l2(got, want) < 2e-2


@pytest.mark.parametrize("num_convs,dtype,jdtype", [
    (2, *DTYPES[1]), (5, *DTYPES[0])])
def test_residual_and_backward_match_jax_kernels(num_convs, dtype, jdtype):
    """Residual mode (out, states, growths) and the backward (d_x, dU,
    dLFF) of the plain versions, which the CPU wrappers take, against the
    JAX kernels on the same weights, input and cotangent."""
    G, params, Gt = _setup(num_convs, seed=num_convs)
    rng = np.random.default_rng(num_convs)
    x = rng.standard_normal((1, 4, 4, 3, 8)).astype(np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(gc=4, num_convs=num_convs)

    packed_j = pack_trunk_params(params, 2, num_convs, 8, 4, jdtype)
    want = fused_rrdb_trunk(packed_j, jnp.asarray(x, jdtype),
                            with_residuals=True, interpret=True, **kw)
    packed = pack_trunk_weights(Gt.rrdbs, dtype)
    before = (rdb_trunk.launches, rdb_trunk.bwd_launches)
    got = rrdb_trunk(packed, torch.from_numpy(x).to(dtype),
                     with_residuals=True, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        _check(g, _f32(w), dtype)

    want_b = fused_rrdb_trunk_bwd(
        pack_trunk_params_bwd(params, 2, num_convs, 8, 4, jdtype), want[2],
        jnp.asarray(d_out, jdtype), interpret=True, **kw)
    got_b = rrdb_trunk_bwd(
        pack_trunk_weights_bwd(packed, nf=8, **kw),
        torch.from_numpy(_f32(want[2])).to(dtype),
        torch.from_numpy(d_out).to(dtype), **kw)
    for g, w in zip(got_b, want_b):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        _check(g, _f32(w), dtype)
    assert (rdb_trunk.launches, rdb_trunk.bwd_launches) == before


def test_backward_needs_a_positive_slope():
    _, _, Gt = _setup(3, seed=1)
    packed = pack_trunk_weights(Gt.rrdbs, torch.float32)
    x = torch.zeros(1, 4, 4, 3, 8)
    _, _, growths = rrdb_trunk(packed, x, gc=4, num_convs=3,
                               with_residuals=True)
    with pytest.raises(ValueError):
        rrdb_trunk_bwd(pack_trunk_weights_bwd(packed, nf=8, gc=4,
                                              num_convs=3),
                       growths, x, gc=4, num_convs=3, negative_slope=0.0)


@pytest.mark.parametrize("num_convs", [2, 5])
def test_trainable_trunk_matches_autograd_of_plain_trunk(num_convs):
    """TrainableTrunk's weight and input gradients (backward plain
    version + dW stage) against torch.autograd through
    rrdb_trunk_reference on the same packed weights."""
    _, _, Gt = _setup(num_convs, seed=20 + num_convs)
    rng = np.random.default_rng(num_convs)
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 5, 8))
                         .astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((2, 4, 3, 5, 8))
                           .astype(np.float32))
    kw = dict(gc=4, num_convs=num_convs)
    geom = dict(rdb_scale=0.2, rrdb_scale=0.2, negative_slope=0.2, **kw)
    grads = []
    for fn in (
        lambda p, v: TrainableTrunk.apply(p["conv"], p["lff"], p["bias"], v,
                                          geom),
        lambda p, v: rrdb_trunk_reference(p, v, **kw),
    ):
        packed = {k: t.clone().requires_grad_() for k, t in
                  pack_trunk_weights(Gt.rrdbs, torch.float32).items()}
        xv = x.clone().requires_grad_()
        (fn(packed, xv) * tgt).sum().backward()
        grads.append([packed["conv"].grad, packed["lff"].grad,
                      packed["bias"].grad, xv.grad])
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5 * scale)


def _grads_vs_jax(num_convs, train, dropout, seed):
    G, params, Gt = _setup(num_convs, seed, init_scale=0.1, dropout=dropout)
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((2, 4, 3, 5, 4)).astype(np.float32)
    z = rng.standard_normal((2, 16, 12, 5, 1)).astype(np.float32)
    tgt = rng.standard_normal((2, 16, 12, 5, 3)).astype(np.float32)
    key = jax.random.key(seed)
    # the mask the JAX forward draws from the same key (fused_apply.py)
    keep = np.array(jax.random.bernoulli(key, 1.0 - dropout,
                                           (2, 1, 1, 1, 12)))

    def loss_j(p):
        out = jax_apply_trainable(G, p, lr, z, train=train, dropout_key=key,
                                  interpret=True)
        return jnp.mean((out - tgt) ** 2)

    v_j, g_j = jax.value_and_grad(loss_j)(params)
    g_j = params_from_jax(jax.tree.map(np.asarray, g_j))
    out = apply_trainable(Gt, torch.from_numpy(lr), torch.from_numpy(z),
                          train=train, dropout_mask=torch.from_numpy(keep))
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    names = dict(Gt.named_parameters())
    assert set(names) == set(g_j)
    for k, p in names.items():
        want = g_j[k]
        scale = max(1e-8, want.abs().max().item())
        torch.testing.assert_close(p.grad, want, rtol=2e-4,
                                   atol=2e-5 * scale, msg=k)


@pytest.mark.parametrize("num_convs", [2, 5])
def test_apply_trainable_grads_match_jax(num_convs):
    """Gradients of every generator parameter through the port's
    trainable trunk against jax.grad of the JAX package's apply_trainable
    (whose own test checks it against flax autodiff)."""
    _grads_vs_jax(num_convs, train=False, dropout=0.0, seed=num_convs)


def test_training_forward_with_jax_drawn_dropout_mask():
    """train=True with channel dropout: the port fed the keep mask that
    JAX draws from its dropout key gives JAX's loss and gradients."""
    _grads_vs_jax(3, train=True, dropout=0.3, seed=7)
