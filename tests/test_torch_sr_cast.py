"""PyTorch port: stochastic rounding to bf16 (``ops/sr_cast.py``) and the
bf16 Adam moments of ``optimizer_state_dtype = "bfloat16_sr"`` against the
JAX package, on the CPU.

- fed the 16-bit draws JAX makes, ``stochastic_round_bf16_with`` gives
  JAX's ``stochastic_round_bf16`` bit for bit;
- over 10⁵ draws each value rounds to one of its two bf16 neighbours and
  the mean is within 0.01 ulp of it (unbiased);
- fed JAX's draws, three updates of the trainer's Adam with bf16 moments
  give the moments of JAX's ``bf16_sr_optimizer_state`` bit for bit and
  its parameters within 1e-6;
- a tiny GAN trains with bf16 moments: its first G step leaves the
  parameters of the float32 run (the update reads the float32 moments),
  each moment one of the two bf16 neighbours of the float32 one; a
  checkpoint round trip keeps them, and a float32 checkpoint does not
  restore into a bf16 state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.ops import sr_cast as jsr
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch.ops import sr_cast
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN


def _jax_bits(key, shape):
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)
                      & jnp.uint32(0xFFFF)).astype(np.int32)


def _bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_sr_cast_equals_jax_on_the_same_draws(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 7)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.0, -2.0, 3.3895314e38, np.inf]  # exact, max, inf
    key = jax.random.key(int(scale * 10) % 97)
    want = jsr.stochastic_round_bf16(jnp.asarray(x), key)
    got = sr_cast.stochastic_round_bf16_with(
        torch.from_numpy(x), torch.from_numpy(_jax_bits(key, x.shape)))
    assert got.dtype == torch.bfloat16
    want_bits = np.asarray(want).view(np.int16)
    np.testing.assert_array_equal(_bf16_bits(got), want_bits)


def test_sr_cast_is_unbiased_over_1e5_draws():
    x = torch.tensor(np.float32(1.0) + np.arange(1, 17, dtype=np.float32)
                     * np.float32(2.0 ** -12))  # 16 offsets within an ulp
    down = (x.view(torch.int32) & -(1 << 16)).view(torch.float32)
    ulp = 2.0 ** -7
    gen = torch.Generator().manual_seed(0)
    draws = sr_cast.stochastic_round_bf16(
        x.repeat(100_000, 1), gen).float()
    assert bool(((draws == down) | (draws == down + ulp)).all())
    mean = draws.double().mean(0)
    bias = (mean - x.double()).abs().max().item()
    assert bias <= 0.01 * ulp, bias / ulp
    # round to nearest is biased by up to half an ulp here
    nearest = (x.to(torch.bfloat16).double() - x.double()).abs().max()
    assert nearest.item() >= 0.4 * ulp


def test_tree_cast_only_float32():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.ones(4, 4), "b": torch.ones(3, dtype=torch.int32),
            "c": torch.ones(2, dtype=torch.bfloat16)}
    out = sr_cast.tree_stochastic_round_bf16(tree, gen)
    assert list(out) == ["a", "b", "c"]
    assert [v.dtype for v in out.values()] == [
        torch.bfloat16, torch.int32, torch.bfloat16]


def test_bf16_adam_equals_jax_fed_its_draws(monkeypatch):
    """The trainer's optimizer (clip, weight decay, Adam) under
    bfloat16_sr, three updates of a two-tensor tree."""
    kw = dict(use_grad_clipping=True, adam_weight_decay_g=0.01,
              optimizer_state_dtype="bfloat16_sr")
    jgan = JaxGAN(tiny_cfg(False, **kw), COORDS, COORDS)
    gan = WindFieldGAN(tiny_cfg(True, **kw), COORDS, COORDS, device="cpu")
    assert gan.moment_dtype == torch.bfloat16
    opt = jgan.opt_G
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jp, jopt = dict(params), opt.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    from gan_sr_wind_field_tpu_torch.train.gan import _adam_init

    topt = _adam_init(tp, torch.bfloat16)
    seed = tiny_cfg(False).env.fixed_seed
    lr = float(np.float32(1e-3))
    queue = []
    monkeypatch.setattr(sr_cast, "draw_bits16",
                        lambda x, generator: queue.pop(0))
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10 ** -step)
                 .astype(np.float32) for k, v in params.items()}
        # the draws JAX's update makes: one key per leaf of the inner
        # state, the float32 (stored bf16) ones cast
        key = jax.random.fold_in(jax.random.key(seed), jopt.count)
        leaves = jax.tree_util.tree_leaves(jopt.inner)
        keys = jax.random.split(key, len(leaves))
        queue[:] = [torch.from_numpy(_jax_bits(k, leaf.shape))
                    for k, leaf in zip(keys, leaves)
                    if leaf.dtype == jnp.bfloat16]
        assert len(queue) == 4  # mu a, mu b, nu a, nu b
        upd, jopt = opt.update(grads, jopt, jp)
        jp = {k: jp[k] + np.asarray(upd[k]) * np.float32(lr) for k in jp}
        gan._adam_step(tp, [torch.from_numpy(grads[k]) for k in tp], topt,
                       lr, *gan.opt_G)
        assert not queue
    adam = [s for s in jopt.inner if hasattr(s, "mu")][0]
    for k in params:
        for name, moment in (("mu", adam.mu), ("nu", adam.nu)):
            got = getattr(topt, name)[k]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _bf16_bits(got), np.asarray(moment[k]).view(np.int16),
                err_msg=f"{name}/{k}")
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-6,
                                   atol=1e-7)
    assert topt.count == 3


def _neighbours(x32):
    down = (x32.view(torch.int32) & -(1 << 16)).view(torch.float32)
    up = ((x32.view(torch.int32) | 0xFFFF) + 1).view(torch.float32)
    return down, up


def test_tiny_gan_trains_with_bf16_moments(tmp_path):
    """G, D, D, G from one state with float32 and with bf16 moments."""
    states = {}
    for dtype in ("float32", "bfloat16_sr"):
        gan = WindFieldGAN(tiny_cfg(True, optimizer_state_dtype=dtype),
                           COORDS, COORDS, device="cpu")
        state = gan.init_state(7, LR_SHAPE, HR_SHAPE)
        seen = []
        for i in range(4):
            state, m = gan.train_step(state, *make_batch(i))
            seen.append((float(m["is_g_step"]), float(m["total"]),
                         float(m["D_train_loss"])))
            if i == 0:
                first = {k: v.clone() for k, v in state.params_G.items()}
                mu = {k: v.clone() for k, v in state.opt_state_G.mu.items()}
        assert [s[0] for s in seen] == [1.0, 0.0, 0.0, 1.0]
        assert all(np.isfinite(s[1:]).all() for s in seen)
        states[dtype] = (gan, state, first, mu)
    gan, state, first, mu = states["bfloat16_sr"]
    _, _, first32, mu32 = states["float32"]
    for opt in (state.opt_state_G, state.opt_state_D):
        moments = [*opt.mu.values(), *opt.nu.values()]
        assert {m.dtype for m in moments} == {torch.bfloat16}
        assert any(m.any() for m in opt.mu.values())
    for k in first32:
        assert torch.equal(first[k], first32[k]), k
        down, up = _neighbours(mu32[k])
        got = mu[k].float()
        assert bool(((got == down) | (got == up)).all()), k

    path = ckpt.save_checkpoint(str(tmp_path / "run"), state)
    example = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    back = ckpt.restore_checkpoint(path, example)
    for o in ("opt_state_G", "opt_state_D"):
        for m in ("mu", "nu"):
            for k, v in getattr(getattr(state, o), m).items():
                got = getattr(getattr(back, o), m)[k]
                assert got.dtype == torch.bfloat16 and torch.equal(got, v)
    gan32, state32, _, _ = states["float32"]
    path32 = ckpt.save_checkpoint(str(tmp_path / "run32"), state32)
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        ckpt.restore_checkpoint(path32, example)
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(path, gan32.init_state(0, LR_SHAPE,
                                                       HR_SHAPE))
