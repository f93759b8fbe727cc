"""PyTorch port: the held-out test chain (``eval/test_loop.py``) and
``run.py``'s inference modes against the JAX package, on the CPU in
float32 at the tiny configuration of ``tests/_torch_tiny.py`` (fused trunk
on) and a synthetic split of 30 hours at 32×32 (2 test fields).

- ``field_metrics`` on seeded random fields: every key within 1e-5
  relative (JAX computes its PSNR in float32, the port in float64);
- ``run_test`` of both packages on the same split with the same pack, raw
  and EMA, ``interpolate_z`` off and on: each CSV the same in header, row
  names, column count and separators, each number within 1e-4 relative
  (PSNR within 1e-3 dB); the field dumps with the same keys and shapes,
  SR within 1e-4;
- ``run_use`` against JAX's in the same way;
- the command line: ``--test``, ``--use`` and ``--serve`` (with
  ``eval.server.serve`` replaced to capture the backend).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.data import preprocess as jax_preprocess
from gan_sr_wind_field_tpu.eval import test_loop as jax_tl
from gan_sr_wind_field_tpu.train.continuation import (
    load_continuation as jax_load_continuation,
)
from gan_sr_wind_field_tpu.train.continuation import save_continuation
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.eval import server
from gan_sr_wind_field_tpu_torch.eval import test_loop as tl
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

HOURS, SIZE = 30, 32


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A float32 pack of a JAX initial state, its EMA slot G × 0.5."""
    jgan = JaxGAN(tiny_cfg(False), np.arange(16, dtype=np.float32),
                  np.arange(16, dtype=np.float32))
    js = jgan.init_state(jax.random.key(3), (1, 4, 4, 4, 4),
                         (1, 16, 16, 4, 3))
    trees = [jax.tree.map(np.asarray, t) for t in
             (js.params_G, js.params_D, js.batch_stats_D)]
    path = str(tmp_path_factory.mktemp("pack") / "init.npz")
    save_continuation(path, *trees,
                      params_G_ema=jax.tree.map(lambda a: a * 0.5, trees[0]),
                      it=0, store_dtype="float32")
    return path


def _cfg(port: bool, root, pack_path, interpolate_z=False):
    cfg = tiny_cfg(port)
    cfg.name = "tinytest"
    cfg.gan_config.interpolate_z = interpolate_z
    cfg.training.log_period = 1  # dump every field
    cfg.use_tensorboard_logger = False
    cfg.also_log_to_terminal = False
    cfg.env.data_root = str(root / "data")
    cfg.env.root_path = str(root)
    cfg.env.this_runs_folder = str(root / "run")
    cfg.env.generator_load_path = pack_path
    return cfg


def _data(port, cfg):
    return (preprocess if port else jax_preprocess)(
        cfg, synthetic=True, synthetic_hours=HOURS, synthetic_size=SIZE)


def test_field_metrics_match_jax():
    rng = np.random.default_rng(0)
    hr, sr, tl_ = (rng.standard_normal((12, 10, 4, 3)).astype(np.float32)
                   for _ in range(3))
    got = tl.field_metrics(hr, hr + 0.1 * sr, tl_, uvw_max=17.5)
    want = jax_tl.field_metrics(hr, hr + 0.1 * sr, tl_, uvw_max=17.5)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def _rows(path):
    """(header, [(name, [cells...])]) of a metrics or averages CSV, cells
    kept as written (separators included)."""
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [(ln.split(",")[0], ln.split(",")[1:])
                      for ln in lines[1:]]


def _same_csv(got_path, want_path):
    h_got, got = _rows(got_path)
    h_want, want = _rows(want_path)
    assert h_got == h_want
    assert [r[0] for r in got] == [r[0] for r in want]
    header = [c.strip() for c in h_want.split(",")]
    for (name, a), (_, b) in zip(got, want):
        assert len(a) == len(b) == len(header) - 1, name
        for col, x, y in zip(header[1:], a, b):
            assert x.startswith(" ") == y.startswith(" "), (name, col)
            x, y = float(x), float(y)
            tol = 1e-3 if "PSNR" in col else 1e-4 * abs(y)
            assert abs(x - y) <= tol, (name, col, x, y)


def _same_fields(got_dir, want_dir, keys):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(want_dir, name), "rb") as f:
            want = pickle.load(f)
        assert sorted(got) == sorted(want) == sorted(keys), name
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            tol = 1e-4 if k.startswith("SR") else 1e-6
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("interpolate_z", [False, True])
def test_run_test_matches_jax(tmp_path, pack, ema, interpolate_z):
    out = {}
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = _cfg(port, root, pack, interpolate_z)
        _, ds_test, _, x, y = _data(port, cfg)
        assert len(ds_test) == 2
        kw = dict(output_root=str(root / "test_output"), ema=ema)
        if port:
            avgs = tl.run_test(cfg, ds_test, x, y, device="cpu", **kw)
        else:
            avgs = jax_tl.run_test(cfg, ds_test, x, y, **kw)
        out[port] = (root, avgs)
    (jroot, javg), (proot, pavg) = out[False], out[True]
    name = "tinytest_ema" if ema else "tinytest"
    csvs = ["averages.csv", f"{name}____metrics.csv"]
    if interpolate_z:
        csvs.append(f"{name}____metrics_reverse_interpolate.csv")
        assert set(pavg["reverse_interpolate"]) == set(
            javg["reverse_interpolate"])
    assert sorted(os.listdir(proot / "test_output")) == sorted(csvs)
    for f in csvs:
        _same_csv(proot / "test_output" / f, jroot / "test_output" / f)
    keys = ["HR", "SR", "TL", "LR", "Z"]
    if interpolate_z:
        keys += ["HR_orig", "Z_orig", "SR_orig"]
    _same_fields(proot / "run" / "fields", jroot / "run" / "fields", keys)


def test_run_use_matches_jax(tmp_path, pack):
    for port in (False, True):
        root = tmp_path / ("port" if port else "jax")
        cfg = _cfg(port, root, pack)
        _, ds_test, _, x, y = _data(port, cfg)
        if port:
            gan = WindFieldGAN(cfg, x, y, device="cpu")
            state = ckpt.load_generator_state(cfg, gan, pack)
            tl.run_use(cfg, ds_test, x, y, state=state, device="cpu")
        else:
            gan = JaxGAN(cfg, x, y)
            example = gan.init_state(jax.random.key(0), (1, 4, 4, 4, 4),
                                     (1, 16, 16, 4, 3))
            params = jax_load_continuation(pack)["params_G"]
            state = example.replace(
                params_G=jax.tree.map(jnp.asarray, params))
            jax_tl.run_use(cfg, ds_test, x, y, state=state)
    _same_fields(tmp_path / "port" / "run" / "fields",
                 tmp_path / "jax" / "run" / "fields", ["LR", "SR"])


def _cli(tmp_path, pack, *flags):
    cfg = _cfg(True, tmp_path, pack)
    ini = str(tmp_path / "tiny.ini")
    cfg.save(ini)
    return run.main(["--cfg", ini, "--synthetic", "--synthetic_hours",
                     str(HOURS), "--synthetic_size", str(SIZE), "--device",
                     "cpu", *flags])


def _newest_run_folder(tmp_path):
    """The run folder of the last command line: run names end in a time
    stamp, and two runs within a second share a folder."""
    return tmp_path / "runs" / sorted(os.listdir(tmp_path / "runs"))[-1]


def test_cli_test_and_use(tmp_path, pack, monkeypatch):
    monkeypatch.chdir(tmp_path)
    avgs = _cli(tmp_path, pack, "--test", "--test_ema")
    assert np.isfinite(avgs["PSNR"])
    with open(tmp_path / "test_output" / "averages.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == tl.AVG_HEADER.strip()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["tinytest_ema"]
    header, rows = _rows(tmp_path / "test_output"
                         / "tinytest_ema____metrics.csv")
    assert header == tl.METRIC_HEADER.strip() and len(rows) == 2

    state = _cli(tmp_path, pack, "--use", "--no_ema")
    fields = _newest_run_folder(tmp_path) / "fields"
    names = sorted(os.listdir(fields))
    assert len(names) == 2
    for name in names:
        with open(fields / name, "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == ["LR", "SR"]
        assert got["LR"].shape == (4, 8, 8, 4)
        assert got["SR"].shape == (3, 32, 32, 4)
    want = WindFieldSR.from_continuation(_cfg(True, tmp_path, pack), pack,
                                         use_ema=False, device="cpu")
    for k, v in want.G.state_dict().items():
        assert np.array_equal(state.params_G[k].numpy(), v.numpy()), k


def test_cli_serve(tmp_path, pack, monkeypatch):
    captured = {}

    def fake_serve(backend, **kw):
        captured.update(kw, backend=backend)
        return "served"

    monkeypatch.setattr(server, "serve", fake_serve)
    assert _cli(tmp_path, pack, "--serve", "0", "--serve_warmup", "1,2",
                "--serve_strict_shapes") == "served"
    backend = captured["backend"]
    assert captured["allowed_shapes"] == [(4, 4, 4, 4)]
    assert captured["tile"] == 4 and captured["block"]
    assert backend.norm_stats is not None
    rng = np.random.default_rng(1)
    lr = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 4, 1)).astype(np.float32)
    want = WindFieldSR.from_continuation(_cfg(True, tmp_path, pack), pack,
                                         device="cpu")
    np.testing.assert_array_equal(backend.upscale(lr, z), want.upscale(lr, z))
