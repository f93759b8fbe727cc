"""PyTorch port: the training loop, checkpoints, warm start and the CLI on
the CPU, at the tiny configuration of ``tests/_torch_tiny.py`` on 6 hours
of synthetic data at 32×32.

- ``train_step(augment=True)`` is ``train_step(augment=False)`` on the
  batch ``augment_batch`` makes from the same draws, exactly;
- the port's ``train`` against the JAX ``train`` (host data path, no
  augmentation, 6 steps from one numpy seed and one initial state, a
  continuation pack both load): the logged losses within 1e-3 of the
  largest entry, the trajectory tolerance of
  ``tests/test_torch_train_step.py``;
- resume is bit-exact (device data, augmentation, dropout and instance
  noise on): 4 steps straight against 2 + save + restore + 2;
- warm start from a pack the JAX package wrote; SIGTERM → checkpoint →
  clean exit; the stall watchdog armed and stopped; the CLI in process.
"""

import json
import os
import re
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu.data import preprocess as jax_preprocess
from gan_sr_wind_field_tpu.train.continuation import save_continuation
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu.train.loop import train as jax_train
from gan_sr_wind_field_tpu.utils.logging import (
    setup_loggers as jax_setup_loggers,
)
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.data.augment import (
    augment_batch_with,
    augment_draws,
)
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train import loop
from gan_sr_wind_field_tpu_torch.train.continuation import load_continuation
from gan_sr_wind_field_tpu_torch.train.gan import GANTrainState, WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers
from gan_sr_wind_field_tpu_torch.utils.torch_import import (
    export_discriminator_state_dict,
    save_reference_checkpoint,
)

HOURS, SIZE = 6, 32
TREES = ("params_G", "params_D", "batch_stats_D", "params_D_frozen",
         "params_G_ema")


def loop_cfg(port: bool, root, niter=6, **training):
    """The tiny configuration with a data root and run folders under
    ``root``: batch 2, no tensorboard, no bar."""
    cfg = tiny_cfg(port, **training)
    cfg.training.niter = niter
    cfg.use_tensorboard_logger = False
    cfg.display_bar = False
    cfg.env.data_root = str(root / "data")
    cfg.env.root_path = str(root)
    cfg.env.this_runs_folder = str(root / "run")
    cfg.env.this_runs_tensorboard_log_folder = str(root / "run" / "tb")
    cfg.dataset_train.batch_size = 2
    cfg.dataset_val.batch_size = 2
    cfg.dataset_train.data_aug_rot = cfg.dataset_train.data_aug_flip = False
    t = cfg.training
    t.val_period = t.log_period = t.save_model_period = 10_000
    return cfg


def _data(cfg):
    return preprocess(cfg, synthetic=True, synthetic_hours=HOURS,
                      synthetic_size=SIZE)


def _train(cfg, **kw):
    ds_train, _, ds_val, x, y = _data(cfg)
    return loop.train(cfg, ds_train, ds_val, x, y, device="cpu", **kw)


def _copy_state(state: GANTrainState) -> GANTrainState:
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    out = GANTrainState(**{f: getattr(state, f) for f in
                           state.__dataclass_fields__})
    for t in TREES:
        tree = getattr(state, t)
        setattr(out, t, None if tree is None
                else {k: v.clone() for k, v in tree.items()})
    for name in ("opt_state_G", "opt_state_D"):
        o = getattr(state, name)
        setattr(out, name, type(o)(o.count.clone(),
                                   {k: v.clone() for k, v in o.mu.items()},
                                   {k: v.clone() for k, v in o.nu.items()}))
    out.rng = rng
    return out


def assert_states_equal(a: GANTrainState, b: GANTrainState):
    assert a.it == b.it
    for t in TREES:
        ta, tb = getattr(a, t), getattr(b, t)
        assert (ta is None) == (tb is None), t
        if ta is not None:
            assert list(ta) == list(tb), t
            for k in ta:
                assert torch.equal(ta[k], tb[k]), f"{t}/{k}"
    for name in ("opt_state_G", "opt_state_D"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count, name
        for k in oa.mu:
            assert torch.equal(oa.mu[k], ob.mu[k]), f"{name}/mu/{k}"
            assert torch.equal(oa.nu[k], ob.nu[k]), f"{name}/nu/{k}"
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_augmented_step_is_the_plain_step_on_the_augmented_batch():
    """Two steps (G, then D) with dropout and instance noise on: the draws
    come from state.rng first, then the step goes on from there."""
    gan = WindFieldGAN(tiny_cfg(True, dropout=0.1, use_instance_noise=True),
                       COORDS, COORDS, device="cpu")
    a = gan.init_state(3, LR_SHAPE, HR_SHAPE)
    b = _copy_state(a)
    for i in range(2):
        batch = [torch.from_numpy(x) for x in make_batch(20 + i)]
        a, ma = gan.train_step(a, *batch, augment=True)
        draws = augment_draws(batch[0].shape[0], b.rng)
        b, mb = gan.train_step(b, *augment_batch_with(*batch, *draws))
        assert ma.keys() == mb.keys()
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        assert_states_equal(a, b)


def _status_losses(log_file):
    with open(log_file) as f:
        lines = f.read()
    steps = {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
             for m in re.finditer(r"it (\d+) G_total (\S+) D (\S+)", lines)}
    val = re.findall(r"validation it (\d+): PSNR (\S+) \(trilinear (\S+)\) "
                     r"G_total (\S+)", lines)
    return steps, val


def _events(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "G_loss/train":
                out[rec["step"]] = rec["values"]
    return out


def test_loop_matches_jax_train(tmp_path):
    """Host data path, no augmentation, 6 steps (G, D, D, G, G, D) and a
    validation at 6, from a float32 pack of a JAX initial state."""
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    js = jgan.init_state(jax.random.key(0), LR_SHAPE, HR_SHAPE)
    pack = str(tmp_path / "init.npz")
    save_continuation(pack, *(jax.tree.map(np.asarray, t) for t in
                              (js.params_G, js.params_D, js.batch_stats_D)),
                      it=0, store_dtype="float32")
    logs = {}
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = loop_cfg(port, root)
        cfg.load_model_from_save = True
        cfg.env.generator_load_path = pack
        cfg.training.log_period = 1
        cfg.training.val_period = 6
        (setup_loggers if port else jax_setup_loggers)(
            str(root / "log"), also_log_to_terminal=False)
        if port:
            state = _train(cfg)
        else:
            ds_train, _, ds_val, x, y = jax_preprocess(
                cfg, synthetic=True, synthetic_hours=HOURS,
                synthetic_size=SIZE)
            state = jax_train(cfg, ds_train, ds_val, x, y)
        assert int(state.it) == 6
        logs[port] = (_status_losses(root / "log" / "status.log"),
                      _events(root / "run" / "tb" / "events.jsonl"))
    (steps_j, val_j), ev_j = logs[False]
    (steps_p, val_p), ev_p = logs[True]
    assert sorted(steps_p) == sorted(steps_j) == list(range(1, 7))
    assert sorted(ev_p) == sorted(ev_j)
    for key in ev_j[1]:
        want = np.array([ev_j[s][key] for s in sorted(ev_j)])
        got = np.array([ev_p[s][key] for s in sorted(ev_j)])
        assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(),
                                                      1e-12), key
    d_j = np.array([steps_j[s][1] for s in sorted(steps_j)])
    d_p = np.array([steps_p[s][1] for s in sorted(steps_j)])
    assert np.abs(d_p - d_j).max() <= 1e-3 * np.abs(d_j).max()
    assert (d_j > 0).sum() == 3  # three D steps
    assert len(val_p) == len(val_j) == 1 and val_p[0][0] == "6"
    for g, w in zip(val_p[0][1:], val_j[0][1:]):
        assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w))


def _resumable_cfg(root, niter):
    cfg = loop_cfg(True, root, niter=niter, dropout=0.1,
                   use_instance_noise=True, g_ema_decay=0.999)
    cfg.device_resident_data = True
    cfg.dataset_train.data_aug_rot = cfg.dataset_train.data_aug_flip = True
    cfg.training.val_period = 2
    return cfg


def test_resume_is_bit_exact(tmp_path):
    """Device data with augmentation, dropout and instance noise on, and a
    validation at 2: 4 steps straight against 2, a save, a new process's
    restore and 2 more. Every tensor and the generator state agree."""
    straight = _train(_resumable_cfg(tmp_path / "a", 4))
    # niter sets the schedules (labels, instance noise), so the first leg
    # keeps it and stops at max_steps
    first = _train(_resumable_cfg(tmp_path / "b", 4), max_steps=2)
    assert first.it == 2
    path = ckpt.latest_checkpoint(str(tmp_path / "b" / "run"))
    assert path.endswith("ckpt_2")
    assert_states_equal(ckpt.restore_checkpoint(path, _copy_state(first)),
                        first)
    cfg = _resumable_cfg(tmp_path / "b", 4)
    cfg.load_model_from_save = True
    cfg.training.resume_training_from_save = True
    resumed = _train(cfg)
    assert_states_equal(resumed, straight)
    assert ckpt.latest_checkpoint(str(tmp_path / "b" / "run")).endswith(
        "ckpt_4")
    images = os.listdir(tmp_path / "a" / "run" / "images")
    assert sorted(images) == ["val_imgs__it_2.pkl", "val_imgs__it_4.pkl"]


def test_checkpoints_prune_and_reconcile_the_ema(tmp_path):
    gan = WindFieldGAN(tiny_cfg(True, g_ema_decay=0.999), COORDS, COORDS,
                       device="cpu")
    state = gan.init_state(0, LR_SHAPE, HR_SHAPE)
    batch = make_batch(1)
    for _ in range(3):
        state, _ = gan.train_step(state, *batch)
        ckpt.save_checkpoint(str(tmp_path), state, keep_last=2)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_"))
    assert names == ["ckpt_2", "ckpt_3"]
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_3") and ckpt.checkpoint_bytes(path) > 0
    fresh = gan.init_state(9, LR_SHAPE, HR_SHAPE)
    assert_states_equal(ckpt.restore_checkpoint(path, fresh), state)
    state, _ = gan.train_step(state, *batch)
    ckpt.save_checkpoint(str(tmp_path), state, keep_last=0)
    assert len(os.listdir(tmp_path)) == 3
    # no EMA in the checkpoint: an EMA configuration seeds it from G
    state.params_G_ema = None
    ckpt.save_checkpoint(str(tmp_path), state)
    got = ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path)),
                                  fresh)
    for k, v in got.params_G_ema.items():
        assert torch.equal(v, state.params_G[k])
        assert v.data_ptr() != got.params_G[k].data_ptr()


@pytest.mark.parametrize("saved, wanted, name", [
    (dict(num_features=8), dict(num_features=12), "feature_conv.weight"),
    (dict(num_RRDB=1), dict(num_RRDB=2), "rrdbs.1.rdbs.0.convs.0.weight"),
])
def test_restore_rejects_another_configuration(tmp_path, saved, wanted, name):
    """A checkpoint of another width or depth raises, naming the tensors
    that differ, as the JAX restore raises for trees that do not match."""
    def state(**generator):
        cfg = tiny_cfg(True)
        for k, v in generator.items():
            setattr(cfg.generator, k, v)
        gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
        return gan.init_state(0, LR_SHAPE, HR_SHAPE)

    path = ckpt.save_checkpoint(str(tmp_path), state(**saved))
    with pytest.raises(ValueError, match=re.escape(f"params_G['{name}']")):
        ckpt.restore_checkpoint(path, state(**wanted))
    # the same configuration restores
    ckpt.restore_checkpoint(path, state(**saved))


@pytest.mark.parametrize("with_ema", [True, False])
def test_warm_start_from_a_jax_pack(tmp_path, with_ema):
    """A pack written by JAX ``save_continuation`` (bf16): G, D and its
    statistics as bridged, ``it`` from the pack, Adam moments zero, the
    EMA from Gema (else from G). No step runs (niter = the pack's it)."""
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    js = jgan.init_state(jax.random.key(1), LR_SHAPE, HR_SHAPE)
    ema = jax.tree.map(lambda a: np.asarray(a) * 0.5, js.params_G)
    pack = str(tmp_path / "pack.npz")
    save_continuation(pack, *(jax.tree.map(np.asarray, t) for t in
                              (js.params_G, js.params_D, js.batch_stats_D)),
                      params_G_ema=ema if with_ema else None, it=7)
    cfg = loop_cfg(True, tmp_path, niter=7, g_ema_decay=0.999)
    cfg.load_model_from_save = True
    cfg.env.generator_load_path = pack
    state = _train(cfg)
    want = load_continuation(pack)
    assert state.it == 7
    g = params_from_jax(want["params_G"])
    for k, v in state.params_G.items():
        assert torch.equal(v, g[k]), k
    e = params_from_jax(want["params_G_ema"] if with_ema
                        else want["params_G"])
    for k, v in state.params_G_ema.items():
        assert torch.equal(v, e[k]), k
    d = d_params_from_jax(want["params_D"], want["batch_stats_D"])
    for k, v in {**state.params_D, **state.batch_stats_D}.items():
        assert torch.equal(v, d[k]), k
    for opt in (state.opt_state_G, state.opt_state_D):
        assert opt.count == 0
        assert all(not m.any() for m in [*opt.mu.values(),
                                          *opt.nu.values()])
    assert ckpt.latest_checkpoint(cfg.env.this_runs_folder) is None


def test_warm_start_branches(tmp_path):
    """A found resume checkpoint wins over the pack; a port checkpoint as
    generator_load_path loads weights only; reference .pth sources load
    (tests/test_torch_reference_import.py holds them against the JAX
    package): G alone with the EMA seeded from it, D alone."""
    cfg = loop_cfg(True, tmp_path, niter=2)
    state = _train(cfg)
    saved = ckpt.latest_checkpoint(cfg.env.this_runs_folder)
    # weights only: it and the optimizers start afresh
    cfg2 = loop_cfg(True, tmp_path / "w", niter=0)
    cfg2.load_model_from_save = True
    cfg2.env.generator_load_path = saved
    loaded = _train(cfg2)
    assert loaded.it == 0 and loaded.opt_state_G.count == 0
    for k, v in loaded.params_G.items():
        assert torch.equal(v, state.params_G[k])
    # the resume checkpoint wins over a pack that does not even exist
    cfg3 = loop_cfg(True, tmp_path, niter=2)
    cfg3.load_model_from_save = True
    cfg3.training.resume_training_from_save = True
    cfg3.env.generator_load_path = str(tmp_path / "missing.npz")
    assert_states_equal(_train(cfg3), state)
    gan = WindFieldGAN(cfg, COORDS, COORDS, device="cpu")
    gan.init_state(0, LR_SHAPE, HR_SHAPE)  # builds gan.D at the patch
    g_pth = save_reference_checkpoint(str(tmp_path / "G_100.pth"),
                                      state.params_G, gan.G)
    d_pth = str(tmp_path / "D_100.pth")
    torch.save(export_discriminator_state_dict(
        state.params_D, state.batch_stats_D, gan.D), d_pth)
    for key, path in (("generator_load_path", g_pth),
                      ("discriminator_load_path", d_pth)):
        cfg4 = loop_cfg(True, tmp_path / "pth", niter=0, g_ema_decay=0.999)
        cfg4.load_model_from_save = True
        setattr(cfg4.env, key, path)
        got = _train(cfg4)
        want = ((("params_G", state.params_G), ("params_G_ema",
                                                 state.params_G))
                if key == "generator_load_path" else
                (("params_D", state.params_D),
                 ("batch_stats_D", state.batch_stats_D)))
        for tree, ref in want:
            for k, v in getattr(got, tree).items():
                assert torch.equal(v, ref[k]), (key, tree, k)
        assert got.it == 0 and got.opt_state_G.count == 0


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch):
    """SIGTERM during step 3 of an endless run: the step finishes, a
    checkpoint is written at 3, and train returns."""
    real = WindFieldGAN.train_step

    def step(self, state, *a, **kw):
        out = real(self, state, *a, **kw)
        if out[0].it == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(WindFieldGAN, "train_step", step)
    cfg = loop_cfg(True, tmp_path, niter=10_000)
    before = signal.getsignal(signal.SIGTERM)
    state = _train(cfg)
    assert state.it == 3
    assert signal.getsignal(signal.SIGTERM) == before
    path = ckpt.latest_checkpoint(cfg.env.this_runs_folder)
    assert path.endswith("ckpt_3")
    assert_states_equal(ckpt.restore_checkpoint(path, _copy_state(state)),
                        state)


def test_host_data_path_stops_its_producer(tmp_path):
    """The host path (``device_resident_data`` off) ends its prefetch
    thread with the leg: before, the producer stayed blocked on its full
    queue after ``train`` returned, holding the batches it had copied."""
    before = set(threading.enumerate())
    state = _train(loop_cfg(True, tmp_path, niter=2))
    assert state.it == 2
    assert [t for t in threading.enumerate() if t not in before] == []


def test_train_loop_arms_and_stops_watchdog(tmp_path, monkeypatch):
    created = []

    class Spy(loop.StallWatchdog):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    monkeypatch.setattr(loop, "StallWatchdog", Spy)
    cfg = loop_cfg(True, tmp_path, niter=3)
    cfg.training.stall_watchdog_s = 60.0
    state = _train(cfg)
    assert state.it == 3
    assert len(created) == 1
    wd = created[0]
    assert wd._last_beat is not None  # armed by real steps
    assert wd._stop.is_set()          # stopped on loop exit


def test_cli_trains_in_process(tmp_path):
    cfg = loop_cfg(True, tmp_path)
    cfg.name = "tinyport"
    cfg.device_resident_data = True
    cfg.dataset_train.data_aug_rot = True
    cfg.training.log_period = 2
    cfg.training.save_model_period = 2
    cfg.training.keep_checkpoints = 1
    cfg.also_log_to_terminal = False
    ini = str(tmp_path / "tiny.ini")
    cfg.save(ini)
    state = run.main(["--cfg", ini, "--train", "--synthetic",
                      "--synthetic_hours", str(HOURS), "--synthetic_size",
                      str(SIZE), "--device", "cpu", "--max_steps", "4"])
    assert state.it == 4
    (name,) = os.listdir(tmp_path / "runs")
    assert name.startswith("tinyport_")
    folder = tmp_path / "runs" / name
    assert sorted(os.listdir(folder)) == ["ckpt_4", "config.ini", "images"]
    events = tmp_path / "tensorboard_log" / name / "events.jsonl"
    assert sorted(_events(events)) == [2, 4]
    assert "it 4 G_total" in (tmp_path / "log" / "status.log").read_text()


@pytest.mark.parametrize("steps,chunk,end", [
    (12, 1, 10),  # per step: stops at iteration 10's boundary
    (12, 4, 10),  # chunks of 4 to 8, then single steps to the window's end
    (6, 1, 6),    # the leg ends first: the trace is written at its end
])
def test_cli_profile_writes_a_trace(tmp_path, steps, chunk, end):
    """``--profile``: a torch.profiler window from the leg's start to the
    first boundary at or after 10 iterations, written as a Chrome/Perfetto
    trace into the run's TensorBoard folder, as JAX writes its trace."""
    cfg = loop_cfg(True, tmp_path, niter=steps)
    cfg.name = "profiled"
    cfg.device_resident_data = chunk > 1
    cfg.steps_per_dispatch = chunk
    cfg.also_log_to_terminal = False
    ini = str(tmp_path / "tiny.ini")
    cfg.save(ini)
    state = run.main(["--cfg", ini, "--train", "--synthetic",
                      "--synthetic_hours", str(HOURS), "--synthetic_size",
                      str(SIZE), "--device", "cpu", "--profile"])
    assert state.it == steps
    (name,) = os.listdir(tmp_path / "tensorboard_log")
    folder = tmp_path / "tensorboard_log" / name
    traces = [n for n in os.listdir(folder) if n.endswith(".pt.trace.json")]
    assert traces == [f"profile_it0-{end}.pt.trace.json"]
    with open(folder / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    status = (tmp_path / "log" / "status.log").read_text()
    assert f"profile of it 0 -> {end} written to" in status


@pytest.mark.parametrize("flag", [["--num_samples", "4"],
                                  ["--asha_grace", "4"],
                                  ["--download"], ["--param_search"],
                                  ["--slurm_array_id", "2"]])
def test_cli_flags_not_ported_raise(flag, tmp_path, monkeypatch):
    """--download raises (no network); the search's flags reach
    param_search with their values (tests/test_torch_search.py runs it)."""
    if flag == ["--download"]:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run.main(["--train", "--synthetic", "--device", "cpu"] + flag)
        return
    cfg = loop_cfg(True, tmp_path, niter=2)
    cfg.also_log_to_terminal = False
    ini = str(tmp_path / "tiny.ini")
    cfg.save(ini)
    seen = {}

    def fake(cfg, *data, **kw):
        seen.update(kw, is_train=cfg.is_train)
        return "searched"

    monkeypatch.setattr(run, "param_search", fake)
    monkeypatch.setenv("N_SHARDS", "3")
    argv = ["--cfg", ini, "--synthetic", "--synthetic_hours", str(HOURS),
            "--synthetic_size", str(SIZE), "--device", "cpu",
            "--param_search"]
    assert run.main(argv + flag[1:] if flag == ["--param_search"]
                    else argv + flag) == "searched"
    want = dict(num_samples=250, grace_period=1200, reduction_factor=3,
                shard_index=1, num_shards=3, is_train=True)
    name = {"--num_samples": "num_samples", "--asha_grace": "grace_period",
            "--slurm_array_id": "shard_index"}.get(flag[0])
    if name:
        want[name] = int(flag[1]) % 3 if name == "shard_index" \
            else int(flag[1])
    assert {k: seen[k] for k in want} == want
