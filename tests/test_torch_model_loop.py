"""PyTorch port on a mesh with a model axis through the user's entry
point: ``run.py --train --device cpu`` under ``torchrun`` with four gloo
ranks on a copy of the tiny configuration with ``[PARALLEL] data_parallel
= 2, tensor_parallel = 2`` (rows over two data rows, G's output channels
over two model ranks), device-resident data with augmentation and
gradient clipping on. Only rank 0 writes; every rank gathers G whole for
each save and validation, so the checkpoint is the one-process format,
and it resumes in one process to the mesh's own next checkpoint. This is
the CPU rehearsal of ``torchrun --nproc_per_node=N ... --train`` with
``tensor_parallel = 2``.
"""

import os

import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from test_torch_loop import HOURS, SIZE, loop_cfg
from test_torch_parallel_loop import TREES, _torchrun


@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    """Four iterations on data 2 x model 2: validation at 2 and 4 on rank
    0 alone, checkpoints at 2 and 4."""
    root = tmp_path_factory.mktemp("torchrun_model")
    cfg = loop_cfg(True, root, niter=4, g_ema_decay=0.999,
                   use_grad_clipping=True)
    cfg.name = "modelrun"
    cfg.device_resident_data = True
    cfg.dataset_train.data_aug_rot = True
    cfg.parallel.data_parallel = 2
    cfg.parallel.tensor_parallel = 2
    t = cfg.training
    t.log_period = t.save_model_period = t.val_period = 2
    ini = str(root / "tiny.ini")
    cfg.save(ini)
    out = _torchrun(ini, nproc=4)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return root, cfg, out


def test_model_train_under_torchrun_writes_on_rank_0_only(model_run):
    """One run folder, both checkpoints (whole: the one-process format),
    each progress line once; the status log names both axes; ranks 1 to 3
    log no progress line."""
    root, cfg, out = model_run
    (name,) = os.listdir(root / "runs")
    assert name.startswith("modelrun_")
    folder = root / "runs" / name
    assert sorted(os.listdir(folder)) == ["ckpt_2", "ckpt_4", "config.ini",
                                          "images"]
    status = (root / "log" / "status.log").read_text()
    assert status.count("it 4 G_total") == 1
    assert status.count("saved checkpoint") == 2
    assert status.count("validation it 4") == 1
    assert "data axis of 2 ranks x model axis of 2" in status
    for r in (1, 2, 3):
        lines = [line for line in out.stdout.splitlines()
                 if line.startswith(f"[default{r}]")]
        assert not any("G_total" in line or "INFO" in line
                       for line in lines), r
    gan = WindFieldGAN(cfg, np.zeros(16, np.float32),
                       np.zeros(16, np.float32), device="cpu")
    example = ckpt.training_example(cfg, gan)
    saved = ckpt.restore_checkpoint(str(folder / "ckpt_4"), example)
    for k, v in example.params_G.items():
        assert saved.params_G[k].shape == v.shape, k


def test_model_checkpoint_resumes_in_one_process(model_run, tmp_path):
    """The mesh's ckpt_2 restores into a one-process run, which trains on
    to 4 through the same batches and ends at the mesh's ckpt_4: G, the
    EMA and D's statistics within 1e-5 relative L2, D within 1e-5 but for
    its biases (2·lr per D step, tests/test_torch_parallel_step.py)."""
    root, cfg, _ = model_run
    (name,) = os.listdir(root / "runs")
    folder = root / "runs" / name
    cfg.load_model_from_save = True
    cfg.training.resume_training_from_save = True
    cfg.env.state_load_path = str(folder / "ckpt_2")
    cfg.env.root_path = str(tmp_path)
    cfg.also_log_to_terminal = False
    cfg.parallel.data_parallel = 1
    cfg.parallel.tensor_parallel = 1
    ini = str(tmp_path / "resume.ini")
    cfg.save(ini)
    state = run.main(["--cfg", ini, "--train", "--synthetic",
                      "--synthetic_hours", str(HOURS), "--synthetic_size",
                      str(SIZE), "--device", "cpu"])
    assert state.it == 4
    gan = WindFieldGAN(cfg, np.zeros(16, np.float32),
                       np.zeros(16, np.float32), device="cpu")
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
