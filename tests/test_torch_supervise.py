"""PyTorch port: the training supervisor
(``gan_sr_wind_field_tpu_torch/scripts/supervise_train.py``) against the
JAX package's ``scripts/supervise_train.py``.

- both supervisors, given the same fake legs, run the same legs (exit
  code, newest checkpoint) with the same decisions: a stall then a
  resume, giving up without a checkpoint, a relaunch from scratch after
  exit 86 or a clean exit before the first save, and ``max_restarts``
  exhausted;
- ``write_resume_cfg`` writes JAX's INI;
- the port's one rule of its own: a ``ckpt_<it>`` holding only
  ``state.pt.tmp`` (a leg killed inside ``save_checkpoint``) is not a
  checkpoint to resume from;
- end to end on the CPU: real ``python -m gan_sr_wind_field_tpu_torch.run
  --train --device cpu`` legs under the port's command line, leg 0
  stopped with SIGTERM after its first save, leg 1 resumed by the
  supervisor; the final ``state.pt`` equals an uninterrupted run's bit for
  bit.
"""

import configparser
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu_torch.scripts import supervise_train as port_sup

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import supervise_train as jax_sup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a leg that reads its config, records what it was given, writes the
# checkpoint its plan says (ckpt_<it>/state.pt) and exits with its code
FAKE_LEG = """\
import configparser, json, os, sys
cfg = sys.argv[sys.argv.index("--cfg") + 1]
plan = json.loads(sys.argv[sys.argv.index("--plan") + 1])
p = configparser.ConfigParser()
p.read(cfg)
root = p.get("ENV", "root_path")
seen = os.path.join(root, "seen.jsonl")
leg = sum(1 for _ in open(seen)) if os.path.exists(seen) else 0
with open(seen, "a") as f:
    f.write(json.dumps([
        p.getboolean("TRAINING", "resume_training_from_save"),
        os.path.basename(p.get("ENV", "state_load_path", fallback=""))])
        + "\\n")
rc, it = plan[leg]
if it is not None:
    ckpt = os.path.join(root, "runs", f"job_leg{leg}", f"ckpt_{it}")
    os.makedirs(ckpt)
    open(os.path.join(ckpt, "state.pt"), "w").close()
sys.exit(rc)
"""

# (exit code, checkpoint written or None) per leg, niter, max_restarts,
# the legs both supervisors must run and the decision they must log
CASES = {
    "stall_then_resume": ([(86, 2), (0, 4)], 4, 3, [(86, 2), (0, 4)],
                          "niter=4 reached"),
    "give_up_without_checkpoint": ([(1, None)], 4, 3, [(1, 0)],
                                   "giving up"),
    "scratch_after_exit_86": ([(86, None), (0, 4)], 4, 3,
                              [(86, 0), (0, 4)], "relaunching from scratch"),
    "scratch_after_clean_exit": ([(0, None), (0, 4)], 4, 3,
                                 [(0, 0), (0, 4)],
                                 "relaunching from scratch"),
    "max_restarts_exhausted": ([(86, 1), (86, 2), (86, 3)], 8, 2,
                               [(86, 1), (86, 2), (86, 3)],
                               "max_restarts exhausted"),
}


def _base_cfg(root, niter=4):
    root.mkdir(parents=True, exist_ok=True)
    cfg = root / "job.ini"
    cfg.write_text(
        "[DEFAULT]\nname = job\nload_model_from_save = False\n"
        "[ENV]\nroot_path = %s\nruns_subpath = /runs\n"
        "[TRAINING]\nniter = %d\nresume_training_from_save = False\n"
        % (root, niter)
    )
    return str(cfg)


def _supervise(module, root, fake, plan, niter, max_restarts):
    cfg = _base_cfg(root, niter)
    logs = []
    legs = module.supervise(cfg, ["--plan", json.dumps(plan)],
                            max_restarts=max_restarts, backoff_s=0,
                            runner=[sys.executable, str(fake)],
                            log=logs.append)
    with open(root / "seen.jsonl") as f:
        seen = [json.loads(line) for line in f]
    # the decisions, with this run's folder out of the lines
    return legs, seen, [m.replace(str(root), "ROOT") for m in logs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervise_decides_as_jax(tmp_path, case):
    """The same fake legs under both supervisors: equal legs (exit code,
    newest checkpoint), the same configs handed to each leg and the same
    log lines, the leg commands and resume paths apart."""
    plan, niter, restarts, want_legs, decision = CASES[case]
    fake = tmp_path / "fake_leg.py"
    fake.write_text(FAKE_LEG)
    runs = {name: _supervise(mod, tmp_path / name, fake, plan, niter,
                             restarts)
            for name, mod in (("jax", jax_sup), ("port", port_sup))}
    (jl, jseen, jlog), (pl, pseen, plog) = runs["jax"], runs["port"]
    assert [(l["rc"], l["reached_it"]) for l in pl] == want_legs
    assert [(l["rc"], l["reached_it"]) for l in jl] == want_legs
    assert [l["leg"] for l in pl] == [l["leg"] for l in jl]
    assert pseen == jseen
    assert plog == jlog
    assert any(decision in m for m in plog)


def test_resume_cfg_is_jax_s(tmp_path):
    cfg = _base_cfg(tmp_path)
    ckpt = str(tmp_path / "runs" / "job_x" / "ckpt_2")
    outs = [mod.write_resume_cfg(cfg, ckpt, str(tmp_path / f"{name}.ini"))
            for name, mod in (("jax", jax_sup), ("port", port_sup))]
    texts = [open(p).read() for p in outs]
    assert texts[0] == texts[1]
    p = configparser.ConfigParser()
    p.read(outs[1])
    assert p.getboolean("DEFAULT", "load_model_from_save")
    assert p.getboolean("TRAINING", "resume_training_from_save")
    assert p.get("ENV", "state_load_path") == os.path.abspath(ckpt)
    assert p.getint("TRAINING", "niter") == 4


def test_read_run_meta_is_jax_s_with_runs_dir_absolute(tmp_path,
                                                      monkeypatch):
    """The same name, niter and runs folder; the port's runs folder is
    absolute, from the directory the legs run in (the working
    directory)."""
    cfg = _base_cfg(tmp_path, niter=7)
    assert port_sup.read_run_meta(cfg) == jax_sup.read_run_meta(cfg)
    rel = tmp_path / "rel.ini"
    rel.write_text("[DEFAULT]\nname = job\n[TRAINING]\nniter = 3\n")
    monkeypatch.chdir(tmp_path)
    assert port_sup.read_run_meta(str(rel)) == (
        "job", 3, str(tmp_path / "runs_root" / "runs"))


def test_a_checkpoint_without_state_pt_is_skipped(tmp_path):
    """The port's own rule: a leg killed inside save_checkpoint leaves
    ``ckpt_<it>/state.pt.tmp`` only; the port's supervisor resumes from
    the newest checkpoint with a ``state.pt`` (the JAX script, which
    reads folder names only, would take the broken one)."""
    runs = tmp_path / "runs"
    for folder, it, name in (("job_a", 4, "state.pt"),
                             ("job_b", 6, "state.pt.tmp"),
                             ("job_b", 2, "state.pt"),
                             ("other_c", 9, "state.pt")):
        (runs / folder / f"ckpt_{it}").mkdir(parents=True)
        (runs / folder / f"ckpt_{it}" / name).write_bytes(b"")
    assert port_sup.find_latest_ckpt(str(runs), "job") == (
        str(runs / "job_a" / "ckpt_4"), 4)
    assert jax_sup.find_latest_ckpt(str(runs), "job")[1] == 6
    assert port_sup.find_latest_ckpt(str(runs), "missing") == (None, 0)
    assert port_sup.find_latest_ckpt(str(tmp_path / "none"), "job") == (
        None, 0)


def test_main_needs_cfg_and_runs_the_port_s_legs(tmp_path, monkeypatch):
    """The command line: without --cfg it exits with a message; its
    default leg is the port's run.py with --train."""
    with pytest.raises(SystemExit, match="--cfg is required"):
        port_sup.main(["--max_restarts", "1"])
    assert port_sup.LEG == [sys.executable, "-m",
                            "gan_sr_wind_field_tpu_torch.run", "--train"]
    calls = []
    monkeypatch.setattr(port_sup, "supervise",
                        lambda cfg, extra, **kw: calls.append(
                            (cfg, extra, kw)) or [{"reached_it": 4}])
    with pytest.raises(SystemExit) as done:
        port_sup.main(["--cfg", _base_cfg(tmp_path), "--device", "cpu",
                       "--backoff_s", "0", "--max_restarts", "1"])
    assert done.value.code == 0
    assert calls == [(str(tmp_path / "job.ini"), ["--device", "cpu"],
                      {"max_restarts": 1, "backoff_s": 0.0})]


# the end-to-end run: the tiny configuration on 6 synthetic hours at
# 32x32, device-resident batches with augmentation, dropout and instance
# noise on (every random draw that a resume must continue), validation
# and saves every 2 iterations
NITER, SAVE = 16, 2
DATA = ["--synthetic", "--synthetic_hours", "6", "--synthetic_size", "32",
        "--device", "cpu"]


def _e2e_cfg(root):
    cfg = tiny_cfg(True, dropout=0.1, use_instance_noise=True,
                   g_ema_decay=0.999)
    cfg.name = "sup"
    cfg.training.niter = NITER
    cfg.training.val_period = 4
    cfg.training.log_period = 2
    cfg.training.save_model_period = SAVE
    cfg.device_resident_data = True
    cfg.use_tensorboard_logger = False
    cfg.display_bar = False
    cfg.also_log_to_terminal = False
    cfg.dataset_train.batch_size = cfg.dataset_val.batch_size = 2
    cfg.env.data_root = str(root / "data")
    cfg.env.root_path = str(root)
    root.mkdir(parents=True)
    path = str(root / "sup.ini")
    cfg.save(path)
    return path


def _children(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def _final_state(root):
    (path,) = [os.path.join(d, f"ckpt_{NITER}", "state.pt")
               for d in (root / "runs").iterdir()
               if (d / f"ckpt_{NITER}").is_dir()]
    return torch.load(path, weights_only=True)


def _assert_blobs_equal(a, b):
    assert a.keys() == b.keys()
    for key, va in a.items():
        vb = b[key]
        if isinstance(va, dict):
            _assert_blobs_equal(va, vb)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), key
        else:
            assert va == vb, key


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="needs /proc")
def test_supervised_cpu_run_resumes_bit_exact_after_sigterm(tmp_path):
    """python -m gan_sr_wind_field_tpu_torch.scripts.supervise_train
    with real CPU legs: leg 0 gets SIGTERM once its first checkpoint is
    written, checkpoints where it stops and exits 0; the supervisor
    resumes leg 1 from that checkpoint to niter and exits 0. The final
    state.pt equals an uninterrupted leg's, every tensor and the random
    generator's state."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    straight = subprocess.Popen(
        [*port_sup.LEG, "--cfg", _e2e_cfg(tmp_path / "straight"), *DATA],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    root = tmp_path / "supervised"
    sup = subprocess.Popen(
        [sys.executable, "-m",
         "gan_sr_wind_field_tpu_torch.scripts.supervise_train", "--cfg",
         _e2e_cfg(root), *DATA, "--backoff_s", "0", "--max_restarts", "2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.monotonic()
        first = None
        while first is None and time.monotonic() - t0 < 300:
            assert sup.poll() is None, sup.communicate()[0]
            runs = root / "runs"
            for d in runs.iterdir() if runs.is_dir() else ():
                if (d / f"ckpt_{SAVE}" / "state.pt").is_file():
                    first = d
            time.sleep(0.005)
        assert first is not None, "leg 0 wrote no checkpoint"
        (leg0,) = _children(sup.pid)
        os.kill(leg0, signal.SIGTERM)
        out, _ = sup.communicate(timeout=300)
        assert sup.returncode == 0, out
        log, _ = straight.communicate(timeout=300)
        assert straight.returncode == 0, log
    finally:
        for p in (sup, straight):
            if p.poll() is None:
                p.kill()
    assert "[supervisor] leg 0 exited rc=0" in out
    assert "[supervisor] leg 1 exited rc=0" in out
    assert f"target niter={NITER} reached" in out
    status = (root / "log" / "status.log").read_text()
    stop = status.split("SIGTERM at it ")[1].split(":")[0]
    assert SAVE <= int(stop) < NITER
    assert f"resumed from {first / f'ckpt_{stop}'} at it={stop}" in status
    cfg = configparser.ConfigParser()
    cfg.read(root / "runs" / "sup_resume_leg1.ini")
    assert cfg.get("ENV", "state_load_path") == str(first / f"ckpt_{stop}")
    _assert_blobs_equal(_final_state(root), _final_state(
        tmp_path / "straight"))
