"""Auto-resume training supervisor of the port (elastic recovery).

    python -m gan_sr_wind_field_tpu_torch.scripts.supervise_train \\
        --cfg CFG.ini [run.py args...] [--max_restarts 10] [--backoff_s 60]

Counterpart of the root ``scripts/supervise_train.py``, with the same
functions, decisions and command line. It launches
``python -m gan_sr_wind_field_tpu_torch.run --train --cfg CFG.ini <args>``
and relaunches it from the newest checkpoint whenever it ends before
``niter``. It is the companion of the stall watchdog
(``train/watchdog.py``, ``[TRAINING] stall_watchdog_s``): the watchdog
turns a hung step into a clean exit (the loop's SIGTERM checkpoint, or the
hard exit 86), and this supervisor brings the run back. Every argument
but its own three goes to each leg, ``--device`` among them (``--device
cpu`` runs the legs on the CPU; without it they run on the card).

Resume legs run generated configs: a copy of the original INI with
``load_model_from_save`` and ``resume_training_from_save`` True and
``[ENV] state_load_path`` at the newest ``ckpt_<it>`` across this run
name's folders (each leg makes its own timestamped run folder). A leg's
exit decides what follows:

- ``niter`` reached: stop; the supervisor exits 0;
- a checkpoint to resume from: relaunch from it, at most ``max_restarts``
  times;
- no checkpoint, exit 86 (the watchdog's hard exit) or 0 short of
  ``niter`` (its graceful exit before the first save): relaunch from
  scratch;
- no checkpoint and any other exit: give up (a real error would only
  crash-loop).

Two departures from the JAX script, both for the port's files:

- a ``ckpt_<it>`` folder counts only when it holds ``state.pt``, as
  ``train/checkpoint.py:latest_checkpoint`` reads them: a leg killed
  inside ``save_checkpoint`` leaves ``state.pt.tmp`` alone in its folder,
  and a resume from that folder would fail on every relaunch;
- the legs run in the supervisor's working directory, and ``root_path``
  is resolved against that same directory, so that the supervisor scans
  the ``runs_dir`` the legs write (the JAX script runs its legs at the
  repository root and scans relative to its own directory).
"""

from __future__ import annotations

import configparser
import os
import re
import subprocess
import sys
import time

# train/checkpoint.py's STATE_FILE; not imported, so that the supervisor
# imports no torch
STATE_FILE = "state.pt"
LEG = [sys.executable, "-m", "gan_sr_wind_field_tpu_torch.run", "--train"]


def read_run_meta(cfg_path):
    """(name, niter, runs_dir) from an INI without building a Config;
    ``runs_dir`` absolute, from the working directory the legs run in."""
    p = configparser.ConfigParser()
    p.read(cfg_path)
    name = p.get("DEFAULT", "name")
    niter = p.getint("TRAINING", "niter")
    root = p.get("ENV", "root_path", fallback="./runs_root")
    runs = p.get("ENV", "runs_subpath", fallback="/runs").strip("/")
    return name, niter, os.path.abspath(
        os.path.join(os.path.expanduser(root), runs))


def find_latest_ckpt(runs_dir, name):
    """Newest ``ckpt_<it>`` holding ``state.pt`` across every
    ``<name>_*`` run folder.

    Returns (path, it) or (None, 0)."""
    best, best_it = None, 0
    if not os.path.isdir(runs_dir):
        return None, 0
    for folder in os.listdir(runs_dir):
        if not (folder == name or folder.startswith(name + "_")):
            continue
        fp = os.path.join(runs_dir, folder)
        for entry in os.listdir(fp) if os.path.isdir(fp) else ():
            m = re.fullmatch(r"ckpt_(\d+)", entry)
            if (m and int(m.group(1)) >= best_it and os.path.isfile(
                    os.path.join(fp, entry, STATE_FILE))):
                best, best_it = os.path.join(fp, entry), int(m.group(1))
    return best, best_it


def write_resume_cfg(cfg_path, ckpt_path, out_path):
    """Copy of ``cfg_path`` flipped into a resume leg from ``ckpt_path``."""
    p = configparser.ConfigParser()
    p.read(cfg_path)
    p["DEFAULT"]["load_model_from_save"] = "True"
    if not p.has_section("ENV"):
        p.add_section("ENV")
    p["ENV"]["state_load_path"] = os.path.abspath(ckpt_path)
    if not p.has_section("TRAINING"):
        p.add_section("TRAINING")
    p["TRAINING"]["resume_training_from_save"] = "True"
    with open(out_path, "w") as f:
        p.write(f)
    return out_path


def supervise(cfg_path, extra_args, max_restarts=10, backoff_s=60,
              runner=None, log=print):
    """Run legs until ``niter`` is reached; returns the leg summaries
    (``leg``, ``rc``, ``reached_it``, ``wall_s``). ``runner`` replaces
    the leg's command before ``--cfg``."""
    name, niter, runs_dir = read_run_meta(cfg_path)
    legs = []
    leg_cfg = cfg_path
    for leg in range(max_restarts + 1):
        cmd = runner or LEG
        cmd = cmd + ["--cfg", leg_cfg] + extra_args
        log(f"[supervisor] leg {leg}: {' '.join(cmd)}")
        t0 = time.time()
        rc = subprocess.call(cmd)
        ckpt, it = find_latest_ckpt(runs_dir, name)
        legs.append({"leg": leg, "rc": rc, "reached_it": it,
                     "wall_s": round(time.time() - t0, 1)})
        log(f"[supervisor] leg {leg} exited rc={rc}, latest ckpt it={it}")
        if it >= niter:
            log(f"[supervisor] target niter={niter} reached")
            break
        if ckpt is None:
            # 86 is the watchdog's hard exit (train/watchdog.py
            # STALL_EXIT_CODE): the runtime died, not the config, so a
            # from-scratch relaunch is safe, counted against max_restarts.
            # 0 short of niter with no checkpoint is the watchdog's
            # graceful start-up deadline (SIGTERM before the first save).
            # Any other exit with no checkpoint is likely a real error
            # that would only crash-loop: give up.
            if rc in (86, 0):
                log("[supervisor] stall death before the first checkpoint "
                    "— relaunching from scratch")
                leg_cfg = cfg_path
                time.sleep(backoff_s)
                continue
            log("[supervisor] no checkpoint to resume from — giving up "
                "(died before the first save_model_period)")
            break
        if leg == max_restarts:
            log("[supervisor] max_restarts exhausted")
            break
        leg_cfg = write_resume_cfg(
            cfg_path, ckpt,
            os.path.join(runs_dir, f"{name}_resume_leg{leg + 1}.ini"),
        )
        log(f"[supervisor] backing off {backoff_s}s, then resuming "
            f"from {ckpt}")
        time.sleep(backoff_s)
    return legs


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            val = cast(argv[i + 1])
            del argv[i:i + 2]
            return val
        return default

    max_restarts = pop("--max_restarts", 10, int)
    backoff_s = pop("--backoff_s", 60, float)
    cfg = pop("--cfg", None, str)
    if cfg is None:
        sys.exit("--cfg is required")
    legs = supervise(cfg, argv, max_restarts=max_restarts,
                     backoff_s=backoff_s)
    ok = legs and legs[-1]["reached_it"] >= read_run_meta(cfg)[1]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
