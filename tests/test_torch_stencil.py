"""PyTorch port: the gradient stencil and its adjoint (plain versions and
the CPU side of their wrappers), ``WindFieldGradient``, the physics
operators, PSNR and the trilinear baseline, against the JAX package on the
CPU. The JAX Pallas kernels run in interpret mode.

Inputs are numpy seeds; float32 throughout. Tolerances: 1e-5 relative
where only the order or grouping of float32 operations differs (the
coefficient form A·f₊ + B·f + C·f₋ against physics.py's fraction form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.ops import metrics as jmetrics
from gan_sr_wind_field_tpu.ops import physics as jphysics
from gan_sr_wind_field_tpu.ops import resize as jresize
from gan_sr_wind_field_tpu.ops.pallas.stencil import (
    _gradient_transpose_pallas,
    wind_field_gradient_fused,
    wind_field_gradient_pallas,
)
from gan_sr_wind_field_tpu_torch.ops import physics, stencil
from gan_sr_wind_field_tpu_torch.ops.metrics import psnr
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy

SHAPES = [(2, 6, 5, 4), (2, 3, 2, 2)]


def _grid(shape, seed):
    N, X, Y, Zl = shape
    rng = np.random.default_rng(seed)
    uvw = rng.standard_normal((N, X, Y, Zl, 3)).astype(np.float32)
    x = np.cumsum(rng.random(X) + 0.5).astype(np.float32) * 100
    y = np.cumsum(rng.random(Y) + 0.5).astype(np.float32) * 100
    Z = (np.cumsum(rng.random((N, X, Y, Zl, 1)) + 0.1, axis=3) * 10
         ).astype(np.float32)
    g9 = rng.standard_normal((N, X, Y, Zl, 9)).astype(np.float32)
    return uvw, x, y, Z, g9


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_kernel_and_physics(shape):
    uvw, x, y, Z, _ = _grid(shape, sum(shape))
    got = stencil.wind_gradient(*_t(uvw, x, y, Z)).numpy()
    assert got.shape == shape + (9,) and got.dtype == np.float32
    _close(got, wind_field_gradient_pallas(uvw, x, y, Z, interpret=True))
    _close(got, jphysics.wind_field_gradient(uvw, x, y, Z))


@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_matches_jax_transpose_kernel(shape):
    _, x, y, Z, g9 = _grid(shape, 7 + sum(shape))
    got = stencil.wind_gradient_adjoint(*_t(g9, x, y, Z)).numpy()
    assert got.shape == shape + (3,)
    _close(got, _gradient_transpose_pallas(g9, x, y, Z, interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_identity(shape):
    """<L u, g> = <u, Lᵀ g> for the plain pair (float64 sums; 1e-5 for
    the float32 stencil arithmetic)."""
    uvw, x, y, Z, g9 = _grid(shape, 3 + sum(shape))
    Lu = stencil.wind_gradient(*_t(uvw, x, y, Z)).double()
    Ltg = stencil.wind_gradient_adjoint(*_t(g9, x, y, Z)).double()
    lhs = (Lu * torch.from_numpy(g9).double()).sum().item()
    rhs = (torch.from_numpy(uvw).double() * Ltg).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_wind_field_gradient_backward_matches_jax_vjp():
    uvw, x, y, Z, g9 = _grid((2, 6, 5, 4), 11)
    _, vjp = jax.vjp(
        lambda u: wind_field_gradient_fused(u, x, y, Z, True), uvw)
    want = vjp(jnp.asarray(g9))[0]
    u, xt, yt, Zt = _t(uvw, x, y, Z)
    u.requires_grad_()
    for t in (xt, yt, Zt):
        t.requires_grad_()
    out = stencil.WindFieldGradient.apply(u, xt, yt, Zt)
    out.backward(torch.from_numpy(g9))
    _close(u.grad.numpy(), want)
    # the grid is data: no gradient reaches it
    assert xt.grad is None and yt.grad is None and Zt.grad is None


def test_cpu_wrappers_launch_no_kernel():
    uvw, x, y, Z, g9 = _grid((1, 4, 4, 3), 5)
    before = (stencil.launches, stencil.adjoint_launches)
    stencil.wind_gradient(*_t(uvw, x, y, Z))
    stencil.wind_gradient_adjoint(*_t(g9, x, y, Z))
    assert (stencil.launches, stencil.adjoint_launches) == before


def test_axis_coeffs_reproduce_physics_gradient():
    """The kernel's 3-term coefficients give physics.py's x gradient."""
    uvw, x, _, _, _ = _grid((1, 7, 3, 2), 2)
    A, B, C = (v.numpy()[None, :, None, None, None]
               for v in stencil.axis_coeffs(torch.from_numpy(x)))
    up = np.concatenate([uvw[:, 1:], uvw[:, -1:]], axis=1)
    dn = np.concatenate([uvw[:, :1], uvw[:, :-1]], axis=1)
    gx, _ = physics.gradient_xy(*_t(uvw, x, x[:3]))
    _close(A * up + B * uvw + C * dn, gx.numpy())


def test_physics_operators_and_norm_factors_match_jax():
    """Gradients, divergences and the four loss factors, with an SR field
    whose z gradient is all negative somewhere so the signed-max quirk of
    the z factor shows."""
    uvw, x, y, Z, _ = _grid((2, 6, 5, 4), 4)
    sr = uvw[::-1].copy() * 3.0
    sr[..., 2] -= np.linspace(0, 50, 4, dtype=np.float32)
    hr_j = jphysics.wind_field_gradient(uvw, x, y, Z)
    sr_j = jphysics.wind_field_gradient(sr, x, y, Z)
    hr_t = physics.wind_field_gradient(*_t(uvw, x, y, Z))
    sr_t = physics.wind_field_gradient(*_t(sr, x, y, Z))
    _close(sr_t.numpy(), sr_j)
    _close(physics.divergence_3d(hr_t).numpy(), jphysics.divergence_3d(hr_j))
    _close(physics.divergence_xy(sr_t).numpy(), jphysics.divergence_xy(sr_j))
    want = jphysics.gradient_norm_factors(hr_j, sr_j)
    got = physics.gradient_norm_factors(hr_t, sr_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    assert got[1].item() == pytest.approx(
        max(hr_t[..., 6:].max().item(), sr_t[..., 6:].max().item() / 100))


def test_bf16_input_computes_in_float32():
    uvw, x, y, Z, _ = _grid((1, 4, 4, 3), 8)
    u16 = torch.from_numpy(uvw).to(torch.bfloat16)
    got = physics.wind_field_gradient(u16, *_t(x, y, Z))
    assert got.dtype == torch.float32
    _close(got.numpy(), jphysics.wind_field_gradient(
        jnp.asarray(u16.float().numpy(), jnp.bfloat16), x, y, Z))


def test_psnr_and_trilinear_match_jax():
    rng = np.random.default_rng(12)
    hr = rng.standard_normal((2, 8, 8, 3, 3)).astype(np.float32)
    sr = hr + 0.1 * rng.standard_normal(hr.shape).astype(np.float32)
    np.testing.assert_allclose(psnr(*_t(hr, sr)).item(),
                               float(jmetrics.psnr(hr, sr)), rtol=1e-6)
    lr = rng.standard_normal((2, 3, 4, 3, 3)).astype(np.float32)
    _close(upsample_trilinear_xy(torch.from_numpy(lr), 4).numpy(),
           jresize.upsample_trilinear_xy(lr, 4), rtol=1e-6)
