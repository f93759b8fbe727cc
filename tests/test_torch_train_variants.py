"""PyTorch port: the training switches of JAX's
``tests/test_train_variants.py`` against the JAX package's WindFieldGAN on
the CPU, float32, at the tiny geometry of ``tests/_torch_tiny.py``:
``gan_type = relativistic``, ``pixel_criterion = l2`` and ``none``,
``flip_labels`` with and without one-sided label smoothing, and smoothing
off.

- one G step: every loss and G gradient at the tolerances of
  ``tests/test_torch_train_step.py``;
- one D step at it 0 and it 30 (the flip and smoothing ramps): D's loss,
  its gradients and batch statistics, the same tolerances;
- six steps (G, D, D, G, G, D, EMA on), each from JAX's state along
  JAX's trajectory: each step's losses within 1e-4 relative, and G, its
  EMA, D and D's statistics after it within 1e-3 of each tensor's largest
  entry, as ``test_eight_step_trajectory_matches_jax`` holds them, but
  for the entries whose gradient sign the two packages' float32 rounding
  does not fix (within 1e-4 of their tensor's largest gradient, or a
  zero-sum tensor: D's last bias under either relativistic loss,
  hr_conv1's bias under ``pixel_criterion = none``, whose total gradient
  is zero up to rounding). Adam's update of such an entry is up to ±lr
  either way, so those are held to 2·lr a step.

Why each step starts from JAX's state: at this size the accumulated
trajectory of ``relativistic``, ``none`` and ``flip_labels`` without
smoothing is not conditioned well enough to compare: JAX's own run from a
D perturbed by 1e-6 relative ends its six steps with D's batch-norm
biases up to 0.26 of their largest entry apart and D's loss 1e-3 apart
(Adam's first updates are sign-like, so a gradient within rounding of
zero flips its entry's step). The variants whose accumulated trajectory
is well conditioned are also held over the six steps unbroken.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)
from test_torch_train_step import (
    _assert_losses,
    _assert_params,
    _g_grads,
    _jax_g_grads,
    _np_tree,
)

VARIANTS = {
    "relativistic": dict(gan_type="relativistic"),
    "l2": dict(pixel_criterion="l2"),
    "none": dict(pixel_criterion="none"),
    "flip_smoothing": dict(flip_labels=True),
    "flip_no_smoothing": dict(flip_labels=True,
                              use_one_sided_label_smoothing=False),
    "no_smoothing": dict(use_one_sided_label_smoothing=False),
}
# the variants whose accumulated six-step trajectory JAX itself keeps
# well conditioned (see the module's docstring)
WELL_CONDITIONED = ("l2", "flip_smoothing", "no_smoothing")
LR = 1e-3  # tiny_cfg's learning rate of G and D
LOSS_KEYS = ("total", "pix", "xy_gradient", "divergence", "adversarial",
             "D_train_loss")
# tensors whose total gradient is zero up to rounding: D's last bias under
# either relativistic loss (invariant to a shift of every logit),
# hr_conv1's bias when only derivatives of the output enter G's loss
ZERO_SUM = {"D": ("fc1.bias",), "none": ("hr_conv1.bias",)}
SIGN_TOL = 1e-4  # of a tensor's largest gradient


@functools.lru_cache(maxsize=None)
def _gans(name):
    """(the JAX GAN, its initial state with an EMA, the port's GAN) of a
    variant, EMA on; built once, so that JAX compiles each step once."""
    kw = dict(VARIANTS[name], g_ema_decay=0.999)
    jgan = JaxGAN(tiny_cfg(False, **kw), COORDS, COORDS)
    jstate = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    jstate = jstate.replace(
        params_G_ema=jax.tree.map(jnp.copy, jstate.params_G))
    gan = WindFieldGAN(tiny_cfg(True, **kw), COORDS, COORDS, device="cpu")
    return jgan, jstate, gan


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """(name, the JAX GAN, its initial state, the port's GAN)."""
    return (request.param, *_gans(request.param))


def _port_state(gan, jstate):
    """The port's state of a JAX state: G, D, D's statistics, the EMA,
    ``it`` and both Adam states (count and moments), as copies."""
    state = gan.state_from_jax(jstate, HR_SHAPE)
    for tree in ("params_G", "params_D", "batch_stats_D", "params_G_ema"):
        setattr(state, tree, {k: v.clone() for k, v in
                              getattr(state, tree).items()})
    for name, conv in (("opt_state_G", params_from_jax),
                       ("opt_state_D", d_params_from_jax)):
        adam = getattr(jstate, name)[0]  # optax's ScaleByAdamState
        opt = getattr(state, name)
        opt.count.fill_(int(adam.count))
        for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for k, v in conv(_np_tree(theirs)).items():
                mine[k].copy_(v)
    return state


def test_one_g_step_matches_jax(variant):
    """G's losses (1e-5 relative) and gradients (1e-4 relative, 1e-5 of
    the largest entry) at it 1; a zero-sum tensor's gradient is within
    rounding of zero on both sides."""
    name, jgan, jstate, gan = variant
    batch = make_batch(1)
    _, want_losses, want = _jax_g_grads(jgan, jstate, batch, 1)
    losses, got = _g_grads(gan, gan.state_from_jax(jstate, HR_SHAPE), batch,
                           1)
    _assert_losses(losses, want_losses)
    assert (float(losses["pix"]) == 0.0) == (name == "none")
    scale = max(w.abs().max().item() for w in want.values())
    for k in ZERO_SUM.get(name, ()):
        assert max(got.pop(k).abs().max().item(),
                   want.pop(k).abs().max().item()) <= 1e-6 * scale, k
    _assert_params(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("it", [0, 30])
def test_one_d_step_matches_jax(variant, it):
    """D's loss (1e-5 relative), gradients (1e-4 relative, 5e-5 of the
    largest entry) and batch statistics (1e-5) at it 0 and 30; D's last
    bias is a zero sum under either relativistic loss (held to rounding
    of zero, 1e-6 of D's largest gradient)."""
    name, jgan, jstate, gan = variant
    state = gan.state_from_jax(jstate, HR_SHAPE)
    lr, hr, z = make_batch(2)
    keys = jgan._split_keys(jstate.rng)

    def loss_j(p):
        fake = jgan._g_forward_nograd(jstate.params_G, lr, z)
        return jgan._d_loss(p, jstate.batch_stats_D, hr[..., :3], fake,
                            jnp.int32(it), keys, True)

    (want_loss, (want_bs, _, _)), want_g = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(jstate.params_D)
    params = {k: v.detach().requires_grad_() for k, v in
              state.params_D.items()}
    fake = gan._g_forward_nograd(state.params_G, torch.from_numpy(lr),
                                 torch.from_numpy(z))
    loss, _, _ = gan._d_loss(params, state.batch_stats_D,
                             torch.from_numpy(hr)[..., :3], fake, it,
                             state.rng, True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(zip(params, gan._grads(loss, params)))
    want = d_params_from_jax(_np_tree(want_g))
    scale = max(w.abs().max().item() for w in want.values())
    for k in ZERO_SUM["D"]:
        assert max(got.pop(k).abs().max().item(),
                   want.pop(k).abs().max().item()) <= 1e-6 * scale, k
    _assert_params(got, want, 1e-4, 5e-5)
    _assert_params(state.batch_stats_D,
                   d_params_from_jax({}, _np_tree(want_bs)), 1e-5, 1e-5)


def _sign_free(gan, state, batch, it, name):
    """{tensor: mask} of the entries of the network that step ``it``
    trains whose gradient is within SIGN_TOL of its tensor's largest
    (their sign not fixed by float32 rounding), and the zero-sum tensors
    whole."""
    lr, hr, z = (torch.from_numpy(a) for a in batch)
    if gan.is_g_step(it):
        _, _, grads = gan.g_grads(state, lr, hr, z, it, state.rng)
        grads = dict(zip(state.params_G, grads))
        whole = ZERO_SUM.get(name, ())
    else:
        gan._set_iteration(it)
        fake = gan._g_forward_nograd(state.params_G, lr, z)
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params_D.items()}
        stats = {k: v.clone() for k, v in state.batch_stats_D.items()}
        loss, _, _ = gan._d_loss(params, stats, hr[..., :3], fake, it,
                                 state.rng, True)
        grads = dict(zip(params, gan._grads(loss, params)))
        whole = ZERO_SUM["D"]
    return {k: (torch.ones_like(g, dtype=torch.bool) if k in whole
                else g.abs() <= SIGN_TOL * g.abs().max())
            for k, g in grads.items()}


def _assert_step(got, want, free, lr):
    """Each tensor within 1e-3 of its largest entry, the entries of
    ``free`` within 2·lr."""
    assert set(got) == set(want)
    for k, w in want.items():
        d = (got[k].detach() - w).abs()
        mask = free.get(k)
        if mask is not None:
            if mask.any():
                assert d[mask].max().item() <= 2 * lr * (1 + 1e-6), k
            d = d[~mask]
        if d.numel():
            assert d.max().item() <= 1e-3 * max(w.abs().max().item(),
                                                 1e-8), k


def test_six_steps_from_jax_states(variant):
    """Six steps along JAX's trajectory, each from JAX's state (the Adam
    moments and counts too): losses within 1e-4 relative, G, its EMA, D
    and D's statistics within 1e-3 of each tensor's largest entry, the
    entries whose gradient sign rounding does not fix within 2·lr."""
    name, jgan, jstate, gan = variant
    jst = jax.tree.map(jnp.copy, jstate)
    kinds = []
    for i in range(6):
        batch = make_batch(20 + i)
        it = int(jst.it) + 1
        free = _sign_free(gan, _port_state(gan, jst), batch, it, name)
        state, mp = gan.train_step(_port_state(gan, jst), *batch)
        jst, mj = jgan.train_step(jax.tree.map(jnp.copy, jst), *batch)
        kinds.append(int(mp["is_g_step"]))
        assert int(mj["is_g_step"]) == kinds[-1]
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(mp[k]), float(mj[k]),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
        g_free = free if kinds[-1] else {}
        _assert_step(state.params_G, params_from_jax(_np_tree(jst.params_G)),
                     g_free, LR)
        _assert_step(state.params_G_ema,
                     params_from_jax(_np_tree(jst.params_G_ema)), g_free, LR)
        _assert_step(state.params_D, d_params_from_jax(_np_tree(
            jst.params_D)), {} if kinds[-1] else free, LR)
        _assert_step(state.batch_stats_D, d_params_from_jax(
            {}, _np_tree(jst.batch_stats_D)), {}, LR)
    assert kinds == [1, 0, 0, 1, 1, 0]


@pytest.mark.parametrize("name", WELL_CONDITIONED)
def test_six_step_trajectory_matches_jax(name):
    """Where JAX's own trajectory is well conditioned, six steps unbroken
    from one state as ``test_eight_step_trajectory_matches_jax`` holds
    eight: losses within 1e-4 relative, G, the EMA, D and its statistics
    within 1e-3 of each tensor's largest entry, D's two last-layer biases
    within 2·lr a D step."""
    jgan, jstate, gan = _gans(name)
    jst = jax.tree.map(jnp.copy, jstate)
    state = gan.state_from_jax(jst, HR_SHAPE)
    for i in range(6):
        batch = make_batch(10 + i)
        jst, mj = jgan.train_step(jst, *batch)
        state, mp = gan.train_step(state, *batch)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(mp[k]), float(mj[k]),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
    _assert_params(state.params_G, params_from_jax(_np_tree(jst.params_G)),
                   1e-3, 1e-3)
    _assert_params(state.params_G_ema,
                   params_from_jax(_np_tree(jst.params_G_ema)), 1e-3, 1e-3)
    want_d = d_params_from_jax(_np_tree(jst.params_D),
                               _np_tree(jst.batch_stats_D))
    got_d = {**state.params_D, **state.batch_stats_D}
    for k in ("fc0.bias", "fc1.bias"):
        assert (got_d.pop(k) - want_d.pop(k)).abs().max() <= 2 * LR * 3
    _assert_params(got_d, want_d, 1e-3, 1e-3)
