"""PyTorch port: WindFieldGAN's G and D steps, an 8-step trajectory, a
G step with the dropout mask JAX draws, validation and the options that
are not ported, against the JAX package's WindFieldGAN on the CPU with the
fused trunk and the stencil kernels on (Pallas in interpret mode).

Both sides start from the same weights (the JAX state through the bridge);
batches are numpy seeds; float32. Instance noise and dropout are off
except where a test feeds JAX's mask, and noisy labels are off, because
the two sides draw different random numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.train import schedule as jschedule
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.train.gan import bce_with_logits as jax_bce
from gan_sr_wind_field_tpu_torch.parallel import make_mesh
from gan_sr_wind_field_tpu_torch.train import schedule
from gan_sr_wind_field_tpu_torch.train.gan import (
    WindFieldGAN,
    _adam_init,
    bce_with_logits,
)
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)


@pytest.fixture(scope="module")
def jax_state0():
    gan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    return gan, gan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)


def _port(state, **cfg_kw):
    gan = WindFieldGAN(tiny_cfg(True, **cfg_kw), COORDS, COORDS,
                       device="cpu")
    return gan, gan.state_from_jax(state, HR_SHAPE)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(got, want, rtol, atol_frac):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(1e-8, w.abs().max().item())
        torch.testing.assert_close(got[k].detach(), w, rtol=rtol,
                                   atol=atol_frac * scale, msg=k)


def _g_grads(gan, state, batch, it, dropout_mask=None):
    _, losses, grads = gan.g_grads(
        state, *(torch.from_numpy(a) for a in batch), it, state.rng,
        dropout_mask=dropout_mask)
    return losses, dict(zip(state.params_G, grads))


def _jax_g_grads(gan, state, batch, it):
    keys = gan._split_keys(state.rng)
    fn = jax.jit(jax.value_and_grad(
        lambda p: gan._g_losses(p, state, *batch, jnp.int32(it), keys, True),
        has_aux=True))
    (_, (losses, _)), grads = fn(state.params_G)
    return keys, losses, params_from_jax(_np_tree(grads))


def _assert_losses(got, want, rtol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v),
                                   rtol=rtol,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("feature_d", [False, True])
def test_g_step_losses_and_grads_match_jax(jax_state0, feature_d):
    """Every loss of _g_losses and every G gradient (rtol 1e-4, atol 1e-5
    of the largest entry: float32 sums in another order through ~10
    layers and the stencil), also with the frozen-D feature loss on."""
    jgan, jstate = jax_state0
    gan, state = _port(jstate)
    if feature_d:
        cfgs = [tiny_cfg(port, feature_D_loss_weight=0.5)
                for port in (False, True)]
        for cfg in cfgs:
            cfg.gan_config.use_D_feature_extractor_cost = True
        jgan = JaxGAN(cfgs[0], COORDS, COORDS)
        jstate = jstate.replace(
            params_D_frozen=jax.tree.map(jnp.copy, jstate.params_D))
        gan = WindFieldGAN(cfgs[1], COORDS, COORDS, device="cpu")
        state = gan.state_from_jax(jstate, HR_SHAPE)
    batch = make_batch(1)
    _, want_losses, want = _jax_g_grads(jgan, jstate, batch, 1)
    losses, got = _g_grads(gan, state, batch, 1)
    assert (float(losses["feature_D"]) > 0) == feature_d
    _assert_losses(losses, want_losses)
    _assert_params(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("clip", [1e-3, 1e3])
def test_adam_step_matches_optax_chain(clip):
    """Three updates of the hand-written optimizer against the optax chain
    the JAX trainer builds (clip_by_global_norm without epsilon, decayed
    weights added before the moments, scale_by_adam, scale(-1)), with the
    clip active and inactive; float32 to 1e-6."""
    cfg = tiny_cfg(True, use_grad_clipping=True, adam_weight_decay_g=0.01)
    cfg.generator.max_norm = clip
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    chain = optax.chain(optax.clip_by_global_norm(clip),
                        optax.add_decayed_weights(0.01),
                        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                        optax.scale(-1.0))
    rng = np.random.default_rng(int(clip * 1000))
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jp, jopt = dict(params), chain.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = _adam_init(tp)
    lr = float(np.float32(1e-3))
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, jopt = chain.update(grads, jopt, jp)
        jp = {k: jp[k] + np.asarray(upd[k]) * np.float32(lr) for k in jp}
        gan._adam_step(tp, [torch.from_numpy(grads[k]) for k in tp], topt,
                       lr, *gan.opt_G)
    assert topt.count == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-6,
                                   atol=1e-7)


def test_d_step_grads_and_statistics_match_jax(jax_state0):
    """D loss (with the -0.1985 bias: at it=0 the smoothed real label is
    exactly 0.9), D gradients and the batch statistics after the step's
    two train-mode forwards. D's gradients to rtol 1e-4 / atol 5e-5 of the
    largest entry and its statistics to 1e-5 of the largest: batch norm
    over a batch of 2 with flax's one-pass variance E[x²] − E[x]² cancels
    about a digit of the float32 sums, whose order differs."""
    jgan, jstate = jax_state0
    gan, state = _port(jstate)
    lr, hr, z = make_batch(2)
    keys = jgan._split_keys(jstate.rng)

    def loss_j(p):
        fake = jgan._g_forward_nograd(jstate.params_G, lr, z)
        return jgan._d_loss(p, jstate.batch_stats_D, hr[..., :3], fake,
                            jnp.int32(0), keys, True)

    (want_loss, (want_bs, _, _)), want_g = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(jstate.params_D)
    params = {k: v.detach().requires_grad_() for k, v in
              state.params_D.items()}
    fake = gan._g_forward_nograd(state.params_G, torch.from_numpy(lr),
                                 torch.from_numpy(z))
    loss, _, _ = gan._d_loss(params, state.batch_stats_D,
                             torch.from_numpy(hr)[..., :3], fake, 0,
                             state.rng, True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_g = dict(zip(params, gan._grads(loss, params)))
    _assert_params(got_g, d_params_from_jax(_np_tree(want_g)), 1e-4, 5e-5)
    _assert_params(state.batch_stats_D,
                   d_params_from_jax({}, _np_tree(want_bs)), 1e-5, 1e-5)


def test_g_step_with_jax_dropout_mask(jax_state0):
    """G dropout 0.1: the port fed the keep mask that JAX's G step draws
    from its g_dropout key gives JAX's losses and G gradients."""
    _, jstate = jax_state0
    jgan = JaxGAN(tiny_cfg(False, dropout=0.1), COORDS, COORDS)
    gan, state = _port(jstate, dropout=0.1)
    batch = make_batch(3)
    keys, want_losses, want = _jax_g_grads(jgan, jstate, batch, 1)
    keep = np.array(jax.random.bernoulli(keys["g_dropout"], 0.9,
                                         (2, 1, 1, 1, 12)))
    assert 0 < keep.sum() < keep.size  # the mask does drop channels
    losses, got = _g_grads(gan, state, batch, 1, torch.from_numpy(keep))
    _assert_losses(losses, want_losses)
    _assert_params(got, want, 1e-4, 1e-5)


def test_eight_step_trajectory_matches_jax(jax_state0):
    """Alternating G, D (period 2, ratio 1), EMA on. Per-step losses to
    1e-4 relative. Final G, EMA and D parameters and D's statistics to
    1e-3 relative to each tensor's largest entry: Adam divides by
    sqrt(nu) ~ |g| on its first steps, so a 1e-6 difference in a small
    gradient becomes a visible difference in that weight's update.

    Two D tensors are held only to the size of their updates (the last
    layer's bias and those entries of the first's whose units have one
    LeakyReLU side for the whole batch): their gradients are multiples of
    the sum over the batch of dL/dlogit, which the relativistic-average
    loss makes zero up to rounding (it is invariant to a shift of all
    logits). Adam turns that rounding into steps of up to ±lr on either
    side, so they may differ by up to 2·lr per D step."""
    _, jstate = jax_state0
    jgan = JaxGAN(tiny_cfg(False, g_ema_decay=0.999), COORDS, COORDS)
    gan, state = _port(jstate, g_ema_decay=0.999)
    jst = jax.tree.map(jnp.copy, jstate)
    jst = jst.replace(params_G_ema=jax.tree.map(jnp.copy, jst.params_G))
    kinds = []
    for i in range(8):
        batch = make_batch(10 + i)
        jst, mj = jgan.train_step(jst, *batch)
        state, mp = gan.train_step(state, *batch)
        kinds.append(int(mp["is_g_step"]))
        assert int(mp["is_g_step"]) == int(mj["is_g_step"])
        for k in ("total", "pix", "xy_gradient", "divergence",
                  "adversarial", "D_train_loss"):
            np.testing.assert_allclose(float(mp[k]), float(mj[k]),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
        assert float(mp["lr_G"]) == pytest.approx(float(mj["lr_G"]))
    assert kinds == [1, 0, 0, 1, 1, 0, 0, 1]
    assert state.it == int(jst.it) == 8
    _assert_params(state.params_G, params_from_jax(_np_tree(jst.params_G)),
                   1e-3, 1e-3)
    _assert_params(state.params_G_ema,
                   params_from_jax(_np_tree(jst.params_G_ema)), 1e-3, 1e-3)
    want_d = d_params_from_jax(_np_tree(jst.params_D),
                               _np_tree(jst.batch_stats_D))
    got_d = {**state.params_D, **state.batch_stats_D}
    for k in ("fc0.bias", "fc1.bias"):
        assert (got_d.pop(k) - want_d.pop(k)).abs().max() <= 2 * 1e-3 * 4
    _assert_params(got_d, want_d, 1e-3, 1e-3)


def test_val_step_matches_jax(jax_state0):
    """Validation metrics and the batch statistics it writes back."""
    jgan, jstate = jax_state0
    gan, state = _port(jstate)
    batch = make_batch(4)
    want, want_bs = jgan.val_step(jstate, *batch)
    got, got_bs = gan.val_step(state, *batch)
    assert set(got) == set(want)
    _assert_losses(got, want, rtol=1e-4)
    assert got_bs is state.batch_stats_D
    _assert_params(got_bs, d_params_from_jax({}, _np_tree(want_bs)), 1e-5,
                   1e-5)


def test_generate_matches_jax(jax_state0):
    jgan, jstate = jax_state0
    gan, state = _port(jstate)
    lr, _, z = make_batch(5)
    want = np.asarray(jgan.generate(jstate.params_G, lr, z))
    got = gan.generate(state, lr, z).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_non_finite_loss_skips_the_whole_g_update(jax_state0):
    _, jstate = jax_state0
    gan, state = _port(jstate)
    lr, hr, z = make_batch(6)
    hr[0, 0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in state.params_G.items()}
    state, metrics = gan.train_step(state, lr, hr, z)
    assert int(metrics["is_g_step"]) == 1
    assert not np.isfinite(float(metrics["total"]))
    assert state.opt_state_G.count == 0  # Adam's count does not move
    for k, v in state.params_G.items():
        assert torch.equal(v, before[k])


def test_fused_trunk_rule_follows_jax(jax_state0):
    """The trunk kernels run where JAX's fused trunk can (a slope > 0, the
    backward reads the sign from the growths). The port has no remat, so
    use_remat leaves the G step on the kernel path, with the same
    gradients as without it."""
    _, jstate = jax_state0
    batch = make_batch(7)
    grads = []
    for remat in (False, True):
        cfg = tiny_cfg(True)
        cfg.generator.use_remat = remat
        gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
        state = gan.state_from_jax(jstate, HR_SHAPE)
        assert gan.use_fused_trunk and gan._trunk == "kernel"
        grads.append(_g_grads(gan, state, batch, 1)[1])
    for k, v in grads[0].items():
        assert torch.equal(grads[1][k], v), k
    cfg = tiny_cfg(True)
    cfg.generator.act_type = "relu"
    assert not WindFieldGAN(cfg, COORDS, COORDS, device="cpu").use_fused_trunk


def test_ema_g_step_count_matches_enumeration():
    gan = WindFieldGAN(tiny_cfg(True, d_g_train_period=3, d_g_train_ratio=2),
                       COORDS, COORDS, device="cpu")
    count = 0
    for it in range(1, 40):
        count += gan.is_g_step(it)
        # steps s in [0, it] that are G steps, minus s = 0
        assert gan._n_g_steps(it) == count


@pytest.mark.parametrize("what", ["mesh", "bfloat16_sr", "horizontal_3D"])
def test_options_not_ported_raise(what):
    """A mesh of any axes is ported (tests/test_torch_parallel*.py,
    tests/test_torch_spatial*.py, tests/test_torch_model_*.py): without a
    process group a mesh with a model or a spatial axis asks for one;
    bfloat16_sr is ported (its
    moments are bf16,
    tests/test_torch_sr_cast.py trains with it), and so is horizontal_3D
    (tests/test_torch_horizontal.py): it builds 6-D kernels and leaves the
    trunk kernels, whatever use_fused_trunk says, as JAX's
    trunk_fusable does."""
    cfg = tiny_cfg(True)
    if what == "bfloat16_sr":
        cfg.training.optimizer_state_dtype = "bfloat16_sr"
        gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
        state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
        for opt in (state.opt_state_G, state.opt_state_D):
            assert {m.dtype for m in [*opt.mu.values(), *opt.nu.values()]} \
                == {torch.bfloat16}
        return
    if what == "horizontal_3D":
        cfg.gan_config.conv_mode = "horizontal_3D"
        gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
        assert cfg.use_fused_trunk and not gan.use_fused_trunk
        assert gan._trunk == gan._head_train == gan._head_nograd == "modules"
        state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
        assert state.params_G["feature_conv.weight"].dim() == 6
        assert state.opt_state_G.mu["feature_conv.weight"].dim() == 6
        assert state.params_D["blocks.0.conv.weight"].dim() == 6
        return
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, 2, 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, 1, 4)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        WindFieldGAN(tiny_cfg(True), COORDS, COORDS)


def test_schedules_and_bce_match_jax():
    fn = schedule.multistep_lr(8e-5, [10, 30], 0.5, 2)
    jfn = jschedule.multistep_lr(8e-5, [10, 30], 0.5, 2)
    for it in (1, 14, 15, 34, 35, 100):
        assert fn(it) == float(jfn(jnp.int32(it)))
    for smooth, flip in ((True, False), (True, True), (False, False)):
        got = schedule.label_values(37, 100.0, smooth, flip)
        want = jschedule.label_values(jnp.int32(37), 100.0, smooth, flip)
        assert got[2:] == want[2:]
        np.testing.assert_array_equal(np.float32(got[:2]),
                                      np.float32(want[:2]))
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(16).astype(np.float32) * 5
    tgt = rng.random(16).astype(np.float32)
    np.testing.assert_allclose(
        bce_with_logits(torch.from_numpy(logits), torch.from_numpy(tgt)),
        float(jax_bce(logits, tgt)), rtol=1e-6)
