"""PyTorch port: the long-run tools against the JAX package's scripts.

- ``gan_sr_wind_field_tpu_torch/scripts/export_continuation.py`` on a
  port checkpoint against ``scripts/export_continuation.py`` on a JAX
  checkpoint of the same weights (carried across with
  ``utils/jax_params.py``): for bf16, ``--fp32``, ``--no-ema`` and both,
  the same keys, equal arrays and the same meta apart from paths, and the
  same printed line;
- ``gan_sr_wind_field_tpu_torch/scripts/summarize_longrun.py`` against
  ``scripts/summarize_longrun.py`` on one run folder that the port's tiny
  loop wrote: equal summaries apart from ``run_folder``, and the same
  JSON file from either command line.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, tiny_cfg
from gan_sr_wind_field_tpu.train import checkpoint as jax_ckpt
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.scripts import export_continuation as port_x
from gan_sr_wind_field_tpu_torch.scripts import summarize_longrun as port_s
from gan_sr_wind_field_tpu_torch.train import checkpoint as port_ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import export_continuation as jax_x  # noqa: E402
import summarize_longrun as jax_s  # noqa: E402

IT = 7


@pytest.fixture(scope="module")
def run_folders(tmp_path_factory):
    """One seeded JAX state at it 7 with an EMA apart from G and moved
    batch statistics, checkpointed by each package in its own format
    into a run folder with the config snapshot."""
    root = tmp_path_factory.mktemp("runs")
    jcfg = tiny_cfg(False, g_ema_decay=0.999)
    gan = JaxGAN(jcfg, COORDS, COORDS)
    state = gan.init_state(jax.random.key(3), LR_SHAPE, HR_SHAPE)
    rng = np.random.default_rng(3)

    def moved(tree, scale):
        return jax.tree.map(lambda p: jnp.asarray(
            np.asarray(p) + scale * rng.standard_normal(p.shape).astype(
                np.float32)), tree)

    state = state.replace(it=jnp.int32(IT),
                          params_G_ema=moved(state.params_G, 0.05),
                          batch_stats_D=moved(state.batch_stats_D, 0.1))
    folders = {"jax": str(root / "jax_run"), "port": str(root / "port_run")}
    for f in folders.values():
        os.makedirs(f)
    jcfg.save(os.path.join(folders["jax"], "config.ini"))
    jax_ckpt.save_checkpoint(folders["jax"], state)
    pcfg = tiny_cfg(True, g_ema_decay=0.999)
    pgan = WindFieldGAN(pcfg, COORDS, COORDS, device="cpu")
    port_ckpt.save_checkpoint(folders["port"],
                              pgan.state_from_jax(state, HR_SHAPE))
    pcfg.save(os.path.join(folders["port"], "config.ini"))
    return folders


def _pack(path):
    with np.load(path) as z:
        return ({k: z[k] for k in z.files if k != "__meta__"},
                json.loads(str(z["__meta__"])))


@pytest.mark.parametrize("flags", [[], ["--fp32"], ["--no-ema"],
                                   ["--fp32", "--no-ema"]],
                         ids=["bf16", "fp32", "no-ema", "fp32-no-ema"])
def test_export_matches_jax(run_folders, flags, monkeypatch, capsys):
    """The pack of the port's checkpoint equals the JAX script's pack of
    the same weights: keys, dtypes, every array, and the meta but the two
    packages' paths; ``--no-ema`` also names the checkpoint with
    ``--ckpt``."""
    outs, lines = {}, {}
    for name, folder in run_folders.items():
        ckpt = os.path.join(folder, f"ckpt_{IT}")
        args = [folder, *flags] + (["--ckpt", ckpt]
                                   if "--no-ema" in flags else [])
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["export_continuation.py",
                                              *args])
            jax_x.main()
        else:
            port_x.main([*args, "--device", "cpu"])
        outs[name] = os.path.join(folder, f"continuation_{IT}.npz")
        lines[name] = capsys.readouterr().out.strip().splitlines()[-1]
        assert lines[name].startswith(f"wrote {outs[name]} (")
    (ja, jm), (pa, pm) = _pack(outs["jax"]), _pack(outs["port"])
    assert sorted(pa) == sorted(ja)
    assert any(k.startswith("Gema/") for k in pa) == ("--no-ema" not in flags)
    for k, want in ja.items():
        assert pa[k].dtype == want.dtype, k
        np.testing.assert_array_equal(pa[k], want, err_msg=k)
    paths = ("source_ckpt", "config")
    assert ({k: v for k, v in pm.items() if k not in paths}
            == {k: v for k, v in jm.items() if k not in paths})
    assert pm["store_dtype"] == ("float32" if "--fp32" in flags
                                 else "bfloat16")
    assert pm["it"] == IT
    if "--fp32" not in flags:
        assert pm["source_ckpt"] == os.path.join(run_folders["port"],
                                                 f"ckpt_{IT}")
        assert pm["config"] == os.path.join(run_folders["port"], "config.ini")
    assert (lines["port"].replace(run_folders["port"], "RUN")
            == lines["jax"].replace(run_folders["jax"], "RUN"))


def test_export_without_a_checkpoint_exits(tmp_path):
    tiny_cfg(True).save(str(tmp_path / "config.ini"))
    with pytest.raises(SystemExit, match="no ckpt_"):
        port_x.main([str(tmp_path), "--device", "cpu"])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run folder of the port's command line: the tiny configuration,
    6 iterations logged each, validated every 2 and saved every 2 (the
    last 2 kept), its events.jsonl in <root>/tensorboard_log/<run>."""
    root = tmp_path_factory.mktemp("summary")
    cfg = tiny_cfg(True)
    cfg.name = "longrun"
    t = cfg.training
    t.niter, t.log_period, t.val_period = 6, 1, 2
    t.save_model_period, t.keep_checkpoints = 2, 2
    cfg.use_tensorboard_logger = False
    cfg.display_bar = False
    cfg.also_log_to_terminal = False
    cfg.dataset_train.batch_size = cfg.dataset_val.batch_size = 2
    cfg.env.data_root = str(root / "data")
    cfg.env.root_path = str(root)
    ini = str(root / "longrun.ini")
    cfg.save(ini)
    run.main(["--cfg", ini, "--train", "--synthetic", "--synthetic_hours",
              "6", "--synthetic_size", "32", "--device", "cpu"])
    (name,) = os.listdir(root / "runs")
    return str(root / "runs" / name)


def test_summary_matches_jax(port_run):
    got, got_dir = port_s.summarize(port_run)
    want, want_dir = jax_s.summarize(port_run)
    assert got_dir == want_dir
    assert got.pop("run_folder") == want.pop("run_folder") == port_run
    assert got == want
    # the loop logged every iteration: D iterations' zero G totals are out
    assert got["last_it"] == 6
    assert got["checkpoints"] == ["ckpt_4", "ckpt_6"]
    assert [it for it, _ in got["val_PSNR_trajectory"]] == [2, 4, 6]
    assert all(np.isfinite(v) for v in got["G_total_train_tail"].values())


def test_summary_command_lines_write_the_same_json(port_run, tmp_path,
                                                   monkeypatch, capsys):
    outs = {name: str(tmp_path / f"{name}.json") for name in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["summarize_longrun.py", port_run,
                                      "--out", outs["jax"]])
    jax_s.main()
    port_s.main([port_run, "--out", outs["port"]])
    capsys.readouterr()
    with open(outs["jax"]) as f:
        want = json.load(f)
    with open(outs["port"]) as f:
        got = json.load(f)
    assert got == want
    assert got["band_plot"] == os.path.join(port_run, "band_plot.png")
    assert os.path.getsize(got["band_plot"]) > 0
