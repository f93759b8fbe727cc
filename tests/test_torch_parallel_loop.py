"""PyTorch port on a data mesh through the user's entry points:
``run.py --train --device cpu`` under ``torchrun`` with two gloo ranks on a
copy of the tiny configuration (only rank 0 writes; its checkpoint resumes
in one process to the mesh's own next checkpoint), ``configs/fullvol.ini``
read as data 2 × spatial 4 and refused on fewer ranks, the one-process
modes refused under ``torchrun``, each rank's rows
of the host path's batches, and ``WindFieldSR(mesh=)`` against the JAX
package's serving on ``make_mesh(8, 1)`` (tests/test_serve.py:112).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dp_worker import spawn
from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.eval.serve import WindFieldSR as JaxSR
from gan_sr_wind_field_tpu.parallel import make_mesh as jax_make_mesh
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.config import load_config
from gan_sr_wind_field_tpu_torch.parallel.mesh import data_axis
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax
from test_torch_loop import HOURS, SIZE, _data, loop_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = ("params_G", "params_G_ema", "params_D", "batch_stats_D")


def _torchrun(ini, *flags, nproc=2, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "--tee", "3", "-m",
           "gan_sr_wind_field_tpu_torch.run", "--cfg", ini, "--train",
           "--synthetic", "--synthetic_hours", str(HOURS),
           "--synthetic_size", str(SIZE), "--device", "cpu", *flags]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Four iterations on two ranks: device-resident data with on-card
    augmentation, validation at 2 and 4, checkpoints at 2 and 4."""
    root = tmp_path_factory.mktemp("torchrun")
    cfg = loop_cfg(True, root, niter=4, g_ema_decay=0.999)
    cfg.name = "meshrun"
    cfg.device_resident_data = True
    cfg.dataset_train.data_aug_rot = True
    t = cfg.training
    t.log_period = t.save_model_period = t.val_period = 2
    ini = str(root / "tiny.ini")
    cfg.save(ini)
    out = _torchrun(ini)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return root, cfg, out


def test_train_under_torchrun_writes_on_rank_0_only(mesh_run):
    """One run folder and one log, each record once, both checkpoints;
    rank 1 logs no progress line."""
    root, _, out = mesh_run
    (name,) = os.listdir(root / "runs")
    assert name.startswith("meshrun_")
    assert sorted(os.listdir(root / "runs" / name)) == [
        "ckpt_2", "ckpt_4", "config.ini", "images"]
    assert sorted(os.listdir(root / "runs" / name / "images")) == [
        "val_imgs__it_2.pkl", "val_imgs__it_4.pkl"]
    assert os.listdir(root / "tensorboard_log") == [name]
    with open(root / "tensorboard_log" / name / "events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r["step"] for r in recs if r["tag"] == "G_loss/train"]
    assert train == [2, 4]
    status = (root / "log" / "status.log").read_text()
    assert status.count("it 4 G_total") == 1
    assert status.count("saved checkpoint") == 2
    assert "data axis of 2 ranks" in status
    rank1 = [line for line in out.stdout.splitlines()
             if line.startswith("[default1]")]
    assert not any("G_total" in line or "INFO" in line for line in rank1)


def test_mesh_checkpoint_resumes_in_one_process(mesh_run, tmp_path):
    """The mesh's ckpt_2 restores into a one-process run, which trains on
    to 4 through the same batches and ends at the mesh's ckpt_4: G, the
    EMA and D's statistics within 1e-5 relative L2, D within 1e-5 but for
    its biases (Adam's near-zero-gradient steps, 2·lr per D step:
    tests/test_torch_parallel_step.py)."""
    root, cfg, _ = mesh_run
    (name,) = os.listdir(root / "runs")
    folder = root / "runs" / name
    cfg.load_model_from_save = True
    cfg.training.resume_training_from_save = True
    cfg.env.state_load_path = str(folder / "ckpt_2")
    cfg.env.root_path = str(tmp_path)
    cfg.also_log_to_terminal = False
    ini = str(tmp_path / "resume.ini")
    cfg.save(ini)
    state = run.main(["--cfg", ini, "--train", "--synthetic",
                      "--synthetic_hours", str(HOURS), "--synthetic_size",
                      str(SIZE), "--device", "cpu"])
    assert state.it == 4
    gan = WindFieldGAN(cfg, np.zeros(16, np.float32), np.zeros(16,
                                                               np.float32),
                       device="cpu")
    want = ckpt.restore_checkpoint(str(folder / "ckpt_4"),
                                   ckpt.training_example(cfg, gan))
    assert torch.equal(state.rng.get_state(), want.rng.get_state())
    for tree in TREES:
        a, b = getattr(state, tree), getattr(want, tree)
        for k in b:
            if tree == "params_D" and k.endswith(".bias"):
                assert (a[k] - b[k]).abs().max() <= 2 * 1e-3, k
            else:
                assert (a[k] - b[k]).norm() <= 1e-5 * b[k].norm() + 1e-12, \
                    (tree, k)


def test_fullvol_config_is_refused():
    """configs/fullvol.ini's [PARALLEL] is data 2 x spatial 4 through
    data_axis on eight ranks (its batch of 8 divides over the data axis),
    and fewer ranks are refused: the port raises before it reads any data
    instead of training on them, under torchrun with 4 ranks as in one
    process. The eight-rank run is tests/test_torch_spatial.py's mesh and
    chip_smoke.py's phase 14."""
    cfg = load_config(os.path.join(REPO, "configs", "fullvol.ini"))
    assert data_axis(cfg.parallel, 8, cfg.dataset_train.batch_size) == (
        2, 1, 4)
    for world in (1, 4, 7):
        with pytest.raises(ValueError, match="nproc_per_node=8"):
            data_axis(cfg.parallel, world, cfg.dataset_train.batch_size)
    with pytest.raises(ValueError, match="nproc_per_node=8"):
        run.main(["--train", "--synthetic", "--cfg",
                  os.path.join(REPO, "configs", "fullvol.ini"), "--device",
                  "cpu"])


@pytest.mark.parametrize("mode", [["--test"], ["--use"], ["--serve", "0"],
                                  ["--export", "x.wsrx"],
                                  ["--param_search"]])
def test_one_process_modes_refuse_torchrun(mode, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one process"):
        run.main(["--synthetic", "--cfg",
                  os.path.join(REPO, "configs", "tiny.ini"), "--device",
                  "cpu", *mode])


def test_data_parallel_needs_its_ranks(tmp_path):
    """[PARALLEL] data_parallel = 2 without torchrun: the port does not
    train on one process instead."""
    cfg = loop_cfg(True, tmp_path, niter=2)
    cfg.parallel.data_parallel = 2
    ini = str(tmp_path / "dp2.ini")
    cfg.save(ini)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        run.main(["--cfg", ini, "--train", "--synthetic", "--device",
                  "cpu"])


def test_host_path_rows_are_the_global_batch(tmp_path):
    """Each rank's rows of the host path's batches: together the batch one
    process assembles, and the numpy generator moves as for the whole."""
    cfg = loop_cfg(True, tmp_path)
    cfg.dataset_train.data_aug_rot = cfg.dataset_train.data_aug_flip = True
    ds, _, _, _, _ = _data(cfg)
    ds.data_aug_rot = ds.data_aug_flip = True

    def batches(rows):
        rng = np.random.default_rng(5)
        out = list(ds.batches(4, rng, epochs=1, rows=rows))
        return out, rng.random()

    whole, after = batches(None)
    halves = [batches(slice(r * 2, r * 2 + 2)) for r in range(2)]
    for i, batch in enumerate(whole):
        for c in range(3):
            np.testing.assert_array_equal(
                np.concatenate([h[0][i][c] for h in halves]), batch[c])
    assert all(h[1] == after for h in halves)


def test_serving_on_a_mesh_matches_jax(tmp_path):
    """``WindFieldSR(mesh=)`` on 2 ranks, 7 fields (padded to 8), against
    JAX's batched serving on make_mesh(8, 1) (2e-4 / 1e-5, JAX's own
    bound), and equal bit for bit to the port in one process; its
    ``upscale_tiled`` (the host loop) equal to one process's."""
    jcfg = tiny_cfg(False)
    x = np.arange(32, dtype=np.float32) * 150
    gan = JaxGAN(jcfg, x, x)
    state = gan.init_state(jax.random.key(0), (8, 4, 4, 4, 4),
                           (8, 16, 16, 4, 3))
    rng = np.random.default_rng(2001)
    lr = rng.standard_normal((7, 4, 4, 4, 4)).astype(np.float32) * 0.1
    zt = rng.standard_normal((7, 16, 16, 4, 1)).astype(np.float32)
    gan_dp = JaxGAN(jcfg, x, x, mesh=jax_make_mesh(8, 1))
    want = JaxSR(gan_dp, state.params_G, mesh=gan_dp.mesh).upscale(
        np.concatenate([lr, lr[:1]]), np.concatenate([zt, zt[:1]]))[:7]
    got = spawn("serve", 2, tmp_path, dict(
        cfg=tiny_cfg(True), params=params_from_jax(
            jax.tree.map(np.asarray, state.params_G)), lr=lr, z=zt,
        field_lr=rng.standard_normal((8, 8, 4, 4)).astype(np.float32) * 0.1,
        field_z=rng.standard_normal((32, 32, 4, 1)).astype(np.float32)))
    assert got["out"].shape == (7, 16, 16, 4, 3) and got["same"]
    np.testing.assert_allclose(got["out"], want, rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got["out"], got["one"])
    np.testing.assert_array_equal(got["tiled"], got["tiled_one"])
