"""PyTorch port: the HR head (hr_conv0 + LeakyReLU + channel dropout)
against the JAX package on the CPU, where the port takes the head's plain
version and the JAX package runs its Pallas kernel in interpret mode.

The head alone against ``_head_forward`` and the custom VJP ``hr_head``
(tests/test_hr_head.py's shapes and tolerances: forward atol 2e-5 / rtol
1e-5, gradients atol 3e-4 / rtol 2e-4), the generator forward with the
head against JAX ``generate_fused`` on a ``pallas_head`` generator, one G
step with ``use_pallas_head`` against the JAX G step, which forwards take
the head under each flag, and the server's warm start. Float32, numpy
seeds, weights through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.models import Generator3D as FlaxGenerator3D
from gan_sr_wind_field_tpu.models.fused_apply import (
    generate_fused as jax_generate_fused,
)
from gan_sr_wind_field_tpu.ops.pallas.hr_head import (
    HeadMeta,
    _head_forward,
)
from gan_sr_wind_field_tpu.ops.pallas.hr_head import hr_head as jax_hr_head
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.eval.server import warmup
from gan_sr_wind_field_tpu_torch.models.fused_apply import generate_fused
from gan_sr_wind_field_tpu_torch.models.generator import Generator3D
from gan_sr_wind_field_tpu_torch.ops import hr_head as head_mod
from gan_sr_wind_field_tpu_torch.ops.hr_head import (
    hr_head,
    hr_head_conv,
    pack_head_weights,
)
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax


def _rand_case(rng, N=2, X=8, Y=8, Z=4, nf=16, tc=4, k=3, C=24):
    """tests/test_hr_head.py:_rand_case as numpy: flax-layout weights."""
    Wx = rng.standard_normal((k, k, k, nf, C)).astype(np.float32) * 0.2
    Wt = rng.standard_normal((k, k, k, tc, C)).astype(np.float32) * 0.2
    x = rng.standard_normal((N, X, Y, Z, nf)).astype(np.float32)
    t = rng.standard_normal((N, X, Y, Z, tc)).astype(np.float32)
    return Wx, Wt, x, t


def _torch_w(w):
    """flax (k, k, k, ci, C) -> torch (C, ci, k, k, k)."""
    return torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous()


def _port_head(Wx, Wt, x, t, dmask, k):
    packed = pack_head_weights(_torch_w(Wx), _torch_w(Wt), torch.float32)
    return hr_head_conv(packed, torch.from_numpy(x), torch.from_numpy(t),
                        None if dmask is None else torch.from_numpy(dmask),
                        k=k, negative_slope=0.2).numpy()


@pytest.mark.parametrize("k,cm", [(3, 16), (3, 24), (5, 8)])
def test_forward_matches_jax(k, cm):
    """All C channels in one tensor against the JAX kernel's main slice
    and remainder, concatenated."""
    Wx, Wt, x, t = _rand_case(np.random.default_rng(k + cm), k=k)
    meta = HeadMeta(k=k, negative_slope=0.2, cm=cm, interpret=True)
    h_main, h_rem = _head_forward(meta, Wx, Wt, x, t, None)
    want = np.concatenate([np.asarray(h_main), np.asarray(h_rem)], -1)
    got = _port_head(Wx, Wt, x, t, None, k)
    assert got.shape == want.shape == (2, 8, 8, 4, 24)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_forward_with_dropout_scale_matches_jax():
    rng = np.random.default_rng(7)
    Wx, Wt, x, t = _rand_case(rng)
    keep = rng.random((2, 24)) > 0.3
    dmask = (keep / 0.7).astype(np.float32)
    meta = HeadMeta(k=3, negative_slope=0.2, cm=16, interpret=True)
    want = np.concatenate(
        [np.asarray(h) for h in jax_hr_head(meta, Wx, Wt, x, t, dmask)], -1)
    got = _port_head(Wx, Wt, x, t, dmask, 3)
    assert (got[np.broadcast_to(~keep[:, None, None, None, :], got.shape)]
            == 0).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_vjp(masked):
    """dWx, dWt, dx and dt of HRHead against jax.grad through the JAX
    custom VJP, with and without a dropout scale."""
    rng = np.random.default_rng(11 + masked)
    Wx, Wt, x, t = _rand_case(rng)
    dmask = ((rng.random((2, 24)) > 0.5) / 0.5).astype(np.float32) \
        if masked else None
    cot = rng.standard_normal((2, 8, 8, 4, 24)).astype(np.float32)
    meta = HeadMeta(k=3, negative_slope=0.2, cm=16, interpret=True)

    def loss(Wx, Wt, x, t):
        hm, hr = jax_hr_head(meta, Wx, Wt, x, t, dmask)
        return jnp.sum(jnp.concatenate([hm, hr], -1) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(Wx, Wt, x, t)
    leaves = [_torch_w(Wx).requires_grad_(), _torch_w(Wt).requires_grad_(),
              torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(t).requires_grad_()]
    h = hr_head(*leaves, None if dmask is None else torch.from_numpy(dmask),
                k=3, negative_slope=0.2)
    (h * torch.from_numpy(cot)).sum().backward()
    got = [leaves[0].grad.permute(2, 3, 4, 1, 0),
           leaves[1].grad.permute(2, 3, 4, 1, 0), leaves[2].grad,
           leaves[3].grad]
    for name, g, w in zip(("dWx", "dWt", "dx", "dt"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-4,
                                   rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("slope", [0.0, -0.1])
def test_nonpositive_slope_raises(slope):
    Wx, Wt, x, t = _rand_case(np.random.default_rng(0))
    with pytest.raises(ValueError, match="negative_slope"):
        hr_head(_torch_w(Wx), _torch_w(Wt), torch.from_numpy(x),
                torch.from_numpy(t), k=3, negative_slope=slope)


def test_packed_shape_is_checked():
    Wx, Wt, x, t = _rand_case(np.random.default_rng(1))
    packed = pack_head_weights(_torch_w(Wx), _torch_w(Wt), torch.float32)
    assert tuple(packed.shape) == (27, 20, 24)
    with pytest.raises(ValueError, match="packed head weights"):
        hr_head_conv(packed, torch.from_numpy(x), torch.from_numpy(t),
                     k=5)


TINY_G = dict(in_channels=4, out_channels=3, num_features=8, num_rrdb=2,
              upscale=4, hr_kern_size=3, rdb_growth_channels=4,
              lff_kern_size=1, terrain_features=4, num_rdb_convs=2)


def test_generator_forward_with_head_matches_jax():
    """The port's generate_fused with the head against JAX generate_fused
    on a pallas_head generator (interpret mode), and against the port's
    own module head."""
    rng = np.random.default_rng(3)
    lr = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 4, 1)).astype(np.float32)
    Gj = FlaxGenerator3D(init_scale=0.5, dropout_probability=0.0,
                         pallas_head=True, **TINY_G)
    params = jax.tree.map(np.asarray, Gj.init(jax.random.key(3), lr, z,
                                              train=False)["params"])
    want = np.asarray(jax_generate_fused(Gj, params, lr, z, interpret=True))
    Gt = Generator3D(**TINY_G)
    Gt.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = generate_fused(Gt.eval(), torch.from_numpy(lr),
                             torch.from_numpy(z), head=True)
        modules = generate_fused(Gt, torch.from_numpy(lr),
                                 torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), modules.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_training_forward_draws_the_module_heads_channels():
    """train=True with dropout 0.3: the head kernel's path draws its keep
    mask as channel_dropout does, so with the same generator seed both
    heads drop the same channels and agree."""
    rng = np.random.default_rng(4)
    lr = torch.from_numpy(rng.standard_normal((2, 4, 4, 4, 4))
                          .astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 16, 16, 4, 1))
                         .astype(np.float32))
    G = Generator3D(**TINY_G, dropout_probability=0.3, init_scale=0.5,
                    generator=torch.Generator().manual_seed(4))
    outs = [G(lr, z, train=True, trunk="kernel", head=head,
              generator=torch.Generator().manual_seed(9))
            for head in ("kernel", "modules")]
    np.testing.assert_allclose(outs[0].detach().numpy(),
                               outs[1].detach().numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown head"):
        G(lr, z, head="pallas")


def _head_cfg(port, dropout=0.1, **flags):
    cfg = tiny_cfg(port, dropout=dropout)
    for k, v in flags.items():
        setattr(cfg, k, v)
    return cfg


def test_g_step_with_head_matches_jax():
    """One G step with use_pallas_head (and G dropout 0.1, the port fed
    JAX's keep mask): every loss and every G gradient against the JAX G
    step with the same flag, at test_torch_train_step.py's tolerances."""
    jgan = JaxGAN(_head_cfg(False, use_pallas_head=True), COORDS, COORDS)
    jstate = jgan.init_state(jax.random.key(0), (2, 4, 4, 4, 4), HR_SHAPE)
    gan = WindFieldGAN(_head_cfg(True, use_pallas_head=True), COORDS, COORDS,
                       device="cpu")
    assert gan._head_train == gan._head_nograd == "kernel"
    state = gan.state_from_jax(jstate, HR_SHAPE)
    batch = make_batch(4)
    keys = jgan._split_keys(jstate.rng)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jgan._g_losses(p, jstate, *batch, jnp.int32(1), keys,
                                 True), has_aux=True))
    (_, (want_losses, _)), want = fn(jstate.params_G)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    keep = np.array(jax.random.bernoulli(keys["g_dropout"], 0.9,
                                         (2, 1, 1, 1, 12)))
    assert 0 < keep.sum() < keep.size
    _, losses, grads = gan.g_grads(
        state, *(torch.from_numpy(a) for a in batch), 1, state.rng,
        dropout_mask=torch.from_numpy(keep))
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    got = dict(zip(state.params_G, grads))
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(1e-8, w.abs().max().item())
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-5 * scale,
                                   msg=k)


@pytest.fixture
def head_calls(monkeypatch):
    """Counts calls of the head's conv (kernel or plain version)."""
    calls = []
    real = head_mod.hr_head_conv

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(head_mod, "hr_head_conv", counting)
    return calls


@pytest.mark.parametrize("flags,g_step,no_grad", [
    ({}, 0, 0),
    ({"use_pallas_head_nograd": True}, 0, 1),
    ({"use_pallas_head": True}, 1, 1),
    ({"use_pallas_head": True, "use_fused_trunk": False}, 0, 0),
])
def test_head_flags_route_forwards(head_calls, flags, g_step, no_grad):
    """Head calls per G step, D step, val_step and generate under each
    flag: use_pallas_head_nograd reaches only the forwards without a
    gradient; neither flag acts without use_fused_trunk."""
    gan = WindFieldGAN(_head_cfg(True, dropout=0.0, **flags), COORDS, COORDS,
                       device="cpu")
    state = gan.init_state(0, (2, 4, 4, 4, 4), HR_SHAPE)
    counts = []
    for it in (1, 2):  # period 2, ratio 1: it 1 is a G step, it 2 a D step
        assert gan.is_g_step(it) == (it == 1)
        before = len(head_calls)
        state, _ = gan.train_step(state, *make_batch(it))
        counts.append(len(head_calls) - before)
    before = len(head_calls)
    gan.val_step(state, *make_batch(5))
    lr, _, z = make_batch(6)
    gan.generate(state, lr, z)
    counts.append(len(head_calls) - before)
    assert counts == [g_step, no_grad, 2 * no_grad]


@pytest.mark.parametrize("flag", ["use_pallas_head_nograd", None])
def test_served_head_and_warmup(head_calls, flag):
    """WindFieldSR takes the head under either flag, and the server's
    warmup runs the forward once per batch size."""
    cfg = _head_cfg(True, dropout=0.0, **({flag: True} if flag else {}))
    G = Generator3D(**dict(TINY_G, num_rrdb=1), init_scale=0.5)
    sr = WindFieldSR(cfg, G.state_dict(), device="cpu")
    assert (sr.head_packed is not None) == (flag is not None)
    warmup(sr, (4, 4, 4, 4), (16, 16, 4, 1), [1, 3])
    assert len(head_calls) == (2 if flag else 0)
    lr, _, z = make_batch(8)
    out = sr.upscale(lr, z)
    assert out.shape == (2, 16, 16, 4, 3) and np.isfinite(out).all()
