"""PyTorch port: ``WindFieldGAN.train_chunk`` and the chunked hot loop
(``steps_per_dispatch`` > 1) on the CPU, at the tiny configuration of
``tests/_torch_tiny.py`` on 6 hours of synthetic data at 32×32.

- ``train_chunk(K)`` is K ``train_step``s on the batches the per-step
  loop's ``DeviceBatcher`` hands them, exactly (on the card the same steps
  run as CUDA graphs: ``tests/test_torch_kernels_cuda.py``);
- a chunked ``train`` hits the boundaries of JAX's
  ``tests/test_chunked_loop.py`` and ends at ``niter``;
- the loop's dispatches, ``(it, n_steps)``, are the JAX loop's on the same
  configuration (both steps replaced by spies that only count);
- a chunked leg's final state is the per-step leg's, exactly, and a
  resumed chunked leg continues the per-iteration stream;
- a G step whose loss is not finite leaves G, both Adam moments and Adam's
  count as they were, as the JAX step does.
"""

import os

import numpy as np
import pytest
import torch

import gan_sr_wind_field_tpu.train.loop as jax_loop
from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.data import preprocess as jax_preprocess
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.utils.logging import (
    setup_loggers as jax_setup_loggers,
)
from gan_sr_wind_field_tpu_torch.config import load_config
from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train import loop
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.loop import TRAIN_LOSS_KEYS
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers
from test_torch_loop import (
    HOURS,
    SIZE,
    _copy_state,
    _data,
    _train,
    assert_states_equal,
    loop_cfg,
)


def _chunk_cfg(root, niter, chunk, **training):
    """The loop tests' configuration on device-resident data with
    augmentation, dropout, instance noise and an EMA, ``chunk`` steps per
    dispatch."""
    cfg = loop_cfg(True, root, niter=niter, dropout=0.1,
                   use_instance_noise=True, g_ema_decay=0.999, **training)
    cfg.device_resident_data = True
    cfg.steps_per_dispatch = chunk
    cfg.dataset_train.data_aug_rot = cfg.dataset_train.data_aug_flip = True
    return cfg


@pytest.mark.parametrize("start,n_steps,augment", [
    (0, 1, False),
    (0, 4, True),   # G, D, D, G: the chunk straddles two blocks
    (3, 3, True),   # D, G, G from a state that has trained
])
def test_train_chunk_is_eager_steps_on_the_batcher_stream(
        tmp_path, start, n_steps, augment):
    cfg = _chunk_cfg(tmp_path, 10, 1)
    ds_train, _, _, x, y = _data(cfg)
    gan = WindFieldGAN(cfg, x, y, device="cpu")
    state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    batcher = DeviceBatcher(ds_train, 2, "cpu", seed=11)
    for _ in range(start):
        state, _ = gan.train_step(state, *next(batcher), augment=augment)
    other = _copy_state(state)
    state, got = gan.train_chunk(
        state, batcher.full, batcher.zraw, batcher.seed, n_steps=n_steps,
        augment=augment, **batcher.slice_kwargs())
    for _ in range(n_steps):
        other, want = gan.train_step(other, *next(batcher), augment=augment)
    assert state.it == start + n_steps
    assert_states_equal(state, other)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _jax_chunk_cfg(root, niter, chunk, **training):
    cfg = loop_cfg(False, root, niter=niter, **training)
    cfg.device_resident_data = True
    cfg.steps_per_dispatch = chunk
    return cfg


def test_chunked_train_hits_the_jax_tests_boundaries(tmp_path):
    """``tests/test_chunked_loop.py:53``: niter 7, K 2, validation and save
    at 4: chunks 0->2->4, validation and checkpoint at 4, a chunk to 6 and a
    single step to 7."""
    cfg = _chunk_cfg(tmp_path, 7, 2)
    t = cfg.training
    t.val_period, t.log_period, t.save_model_period = 4, 2, 4
    setup_loggers(str(tmp_path / "log"), also_log_to_terminal=False)
    state = _train(cfg)
    assert state.it == 7
    run = cfg.env.this_runs_folder
    assert sorted(n for n in os.listdir(run) if n.startswith("ckpt_")) == [
        "ckpt_4", "ckpt_7"]
    assert os.listdir(os.path.join(run, "images")) == ["val_imgs__it_4.pkl"]
    status = (tmp_path / "log" / "status.log").read_text()
    assert [f"it {i} G_total" in status for i in (2, 4, 6)] == [True] * 3
    assert all(np.isfinite(v.numpy()).all() for v in state.params_G.values())


_SCHEDULES = [
    # niter, K, log, val, save: the JAX test's; chunks cut at every
    # boundary; K wider than any gap (single steps only); a remainder
    (7, 2, 2, 4, 4),
    (11, 3, 4, 6, 5),
    (9, 5, 3, 100, 100),
    (13, 4, 100, 100, 6),
]


def _spy_dispatches(monkeypatch, owner, validation_owner, calls, advance,
                    metrics):
    """Replace ``owner``'s train_step and train_chunk by spies that record
    ``(it, n_steps)`` and advance the state, and the loop's validation by
    one that records its iteration."""
    def step(self, state, *a, **kw):
        calls.append((int(state.it), 1))
        return advance(state, 1), metrics

    def chunk(self, state, *a, n_steps, **kw):
        calls.append((int(state.it), n_steps))
        return advance(state, n_steps), metrics

    def validation(cfg, gan, state, *a):
        calls.append(("val", int(state.it)))
        return state

    monkeypatch.setattr(owner, "train_step", step)
    monkeypatch.setattr(owner, "train_chunk", chunk)
    monkeypatch.setattr(validation_owner, "run_validation", validation)


def _advance_port(state, n):
    state.it += n
    return state


@pytest.mark.parametrize("niter,chunk,log,val,save", _SCHEDULES)
def test_dispatches_are_the_jax_loops(tmp_path, monkeypatch, niter, chunk,
                                      log, val, save):
    calls = {}
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = (_chunk_cfg if port else _jax_chunk_cfg)(root, niter, chunk)
        t = cfg.training
        t.log_period, t.val_period, t.save_model_period = log, val, save
        calls[port] = []
        if port:
            zero = torch.zeros(())
            _spy_dispatches(monkeypatch, WindFieldGAN, loop, calls[port],
                            _advance_port,
                            {k: zero for k in (*TRAIN_LOSS_KEYS,
                                               "D_train_loss", "is_g_step")})
            _train(cfg)
        else:
            jax_setup_loggers(str(root / "log"), also_log_to_terminal=False)
            _spy_dispatches(monkeypatch, JaxGAN, jax_loop, calls[port],
                            lambda s, n: s.replace(it=s.it + n),
                            {k: np.float32(0) for k in (*TRAIN_LOSS_KEYS,
                                                         "D_train_loss",
                                                         "is_g_step")})
            ds_train, _, ds_val, x, y = jax_preprocess(
                cfg, synthetic=True, synthetic_hours=HOURS,
                synthetic_size=SIZE)
            jax_loop.train(cfg, ds_train, ds_val, x, y)
    assert calls[True] == calls[False]
    steps = [c for c in calls[True] if c[0] != "val"]
    assert sum(n for _, n in steps) == niter
    assert any(n == chunk for _, n in steps) == (chunk <= min(log, val, save,
                                                              niter))


@pytest.mark.parametrize("resident", [True, False])
def test_longrun_config_reaches_train_chunk(tmp_path, monkeypatch, caplog,
                                            resident):
    """``configs/longrun12k_leg3.ini`` sets steps_per_dispatch = 50 with
    device-resident data: at its periods (log 200, validation 500, save
    2000) its first 600 iterations go as 4 chunks of 50 to the log at 200,
    and so on, never a single step. Without device-resident data the key
    cannot be honoured, and the loop says so."""
    longrun = load_config(os.path.join(os.path.dirname(__file__), "..",
                                       "configs", "longrun12k_leg3.ini"))
    assert longrun.steps_per_dispatch == 50 and longrun.device_resident_data
    cfg = _chunk_cfg(tmp_path, 600, longrun.steps_per_dispatch)
    cfg.device_resident_data = resident
    for k in ("log_period", "val_period", "save_model_period"):
        setattr(cfg.training, k, getattr(longrun.training, k))
    calls = []
    zero = torch.zeros(())
    _spy_dispatches(monkeypatch, WindFieldGAN, loop, calls, _advance_port,
                    {k: zero for k in (*TRAIN_LOSS_KEYS, "D_train_loss",
                                       "is_g_step")})
    with caplog.at_level("WARNING", logger="status"):
        _train(cfg)
    steps = [c for c in calls if c[0] != "val"]
    if resident:
        assert steps == [(i, 50) for i in range(0, 600, 50)]
        assert ("val", 500) in calls
        assert "needs device_resident_data" not in caplog.text
    else:
        assert steps == [(i, 1) for i in range(600)]
        assert "steps_per_dispatch = 50 needs device_resident_data" in \
            caplog.text


@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_leg_is_the_per_step_leg(tmp_path, chunk):
    """Validation at 4 and 8, checkpoints at 5: every state tensor, the
    generator's state and the last checkpoint agree bit for bit."""
    states = []
    for k in (1, chunk):
        cfg = _chunk_cfg(tmp_path / str(k), 9, k)
        t = cfg.training
        t.val_period, t.save_model_period, t.log_period = 4, 5, 3
        states.append(_train(cfg))
    assert_states_equal(*states)
    for k in (1, chunk):
        run = _chunk_cfg(tmp_path / str(k), 9, k).env.this_runs_folder
        assert ckpt.latest_checkpoint(run).endswith("ckpt_9")


def test_resumed_chunked_leg_continues_the_stream(tmp_path, monkeypatch):
    """As ``tests/test_chunked_loop.py:71`` for JAX: the resumed leg hands
    its iteration to ``DeviceBatcher`` (start_count), and its chunks train
    on the batches of their iterations: the legs 0->3 and 3->7, chunked,
    end where 0->7 per step does."""
    captured = []
    real = loop.DeviceBatcher

    class Spy(real):
        def __init__(self, *a, **kw):
            captured.append(kw.get("start_count"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(loop, "DeviceBatcher", Spy)
    straight = _train(_chunk_cfg(tmp_path / "a", 7, 1))
    # niter sets the schedules: the first leg keeps it, stops at max_steps
    first = _train(_chunk_cfg(tmp_path / "b", 7, 2), max_steps=3)
    assert first.it == 3
    cfg = _chunk_cfg(tmp_path / "b", 7, 2)
    cfg.load_model_from_save = True
    cfg.training.resume_training_from_save = True
    resumed = _train(cfg)
    assert captured == [0, 0, 3]
    assert_states_equal(resumed, straight)


def test_non_finite_g_step_leaves_g_and_adam_as_they_were():
    """Two steps (G, D) first, so the moments are not zero; then a G step
    on a batch with a NaN: the loss is not finite, and G, both moments of
    G's Adam and its count keep their values, as JAX's ``jnp.where``
    keeps them (``gan_sr_wind_field_tpu/train/gan.py:640-655``)."""
    gan = WindFieldGAN(tiny_cfg(True, d_g_train_period=1), COORDS, COORDS,
                       device="cpu")
    state = gan.init_state(5, LR_SHAPE, HR_SHAPE)
    for i in range(3):  # it 1 D, 2 G, 3 D (period 1, ratio 1)
        state, _ = gan.train_step(state, *make_batch(30 + i))
    opt = state.opt_state_G
    assert int(opt.count) == 1 and gan.is_g_step(4)
    before = _copy_state(state)
    lr, hr, z = make_batch(40)
    hr[1, 3, 2, 1, 0] = np.nan
    state, metrics = gan.train_step(state, lr, hr, z)
    assert int(metrics["is_g_step"]) == 1
    assert not np.isfinite(float(metrics["total"]))
    assert int(opt.count) == 1
    for k in state.params_G:
        assert torch.equal(state.params_G[k], before.params_G[k]), k
        assert torch.equal(opt.mu[k], before.opt_state_G.mu[k]), k
        assert torch.equal(opt.nu[k], before.opt_state_G.nu[k]), k
    assert any(bool(m.any()) for m in opt.mu.values())
