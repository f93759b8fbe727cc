"""Summarize a long training run of the port into its evidence record
(stable D/G losses, LR milestones crossed, the EMA, the validation PSNR's
trajectory) and draw the thesis band figure.

    python -m gan_sr_wind_field_tpu_torch.scripts.summarize_longrun \\
        RUN_FOLDER [--out summary.json]

Counterpart of the root ``scripts/summarize_longrun.py``, with the same
keys, on the port's files: the run's ``events.jsonl`` (``utils/tb.py``,
read by ``viz/analysis.py:read_events``), its config snapshot and its
``ckpt_*`` folders. It writes the JSON summary beside the run (and prints
it) and the band plot (``viz/analysis.py:exp_comparison_plot``).
"""

import configparser
import json
import os
import sys

import numpy as np

from gan_sr_wind_field_tpu_torch.viz.analysis import (
    exp_comparison_plot,
    read_events,
)


def _series(ev, key):
    if key not in ev:
        print(f"WARNING: events key {key!r} absent — summary entries "
              "derived from it will be null (renamed TB tag?)",
              file=sys.stderr)
    d = ev.get(key, {"step": [], "value": []})
    return np.asarray(d["step"]), np.asarray(d["value"], dtype=np.float64)


def summarize(run_folder: str) -> "tuple[dict, str]":
    """(the summary, the folder of its events.jsonl) of ``run_folder``."""
    tb_dir = None
    root = os.path.dirname(os.path.dirname(run_folder))
    for p in (
        os.path.join(run_folder, "tensorboard_log"),
        os.path.join(run_folder, "tb"),
        # run.py's layout: <root>/tensorboard_log/<run_name> beside
        # <root>/runs/<run_name>
        os.path.join(root, "tensorboard_log", os.path.basename(run_folder)),
    ):
        if os.path.exists(os.path.join(p, "events.jsonl")):
            tb_dir = p
    if tb_dir is None:
        raise SystemExit(f"no events.jsonl under {run_folder}")
    ev = read_events(tb_dir)

    it_p, psnr = _series(ev, "metrics/PSNR/val_PSNR")
    _, tri = _series(ev, "metrics/PSNR/Trilinear_PSNR")
    it_g, g_tot = _series(ev, "G_loss/train/total")
    it_adv, g_adv = _series(ev, "G_loss/train/adversarial")
    it_d, d_val = _series(ev, "D_loss//validation_loss")
    _, g_val = _series(ev, "G_loss/validation/total")
    it_gn, g_norm = _series(ev, "metrics/grad/G_grad_norm")

    # G_loss/train/total is logged on both G and D iterations; on D blocks
    # the G branch did not run and total is 0: those are dropped
    g_mask = g_tot != 0.0
    it_g, g_tot = it_g[g_mask], g_tot[g_mask]

    def _traj(steps, vals, keep=20):
        idx = np.unique(
            np.linspace(0, len(steps) - 1, min(keep, len(steps))).astype(int)
        ) if len(steps) else []
        return [[int(steps[i]), round(float(vals[i]), 3)] for i in idx]

    def _tail_stats(vals, frac=0.25):
        if not len(vals):
            return None
        tail = vals[int(len(vals) * (1 - frac)):]
        return {"mean": round(float(np.mean(tail)), 4),
                "std": round(float(np.std(tail)), 4),
                "min": round(float(np.min(tail)), 4),
                "max": round(float(np.max(tail)), 4)}

    saves = sorted(
        (n for n in os.listdir(run_folder) if n.startswith("ckpt_")),
        key=lambda n: int(n.split("_")[1]),
    )

    # the config snapshot: LR milestones and the EMA
    snap = {}
    for cand in os.listdir(run_folder):
        if cand.endswith(".ini"):
            c = configparser.ConfigParser()
            c.read(os.path.join(run_folder, cand))
            if c.has_section("TRAINING"):
                snap["multistep_lr_steps"] = c.get(
                    "TRAINING", "multistep_lr_steps", fallback=None)
                snap["g_ema_decay"] = c.get(
                    "TRAINING", "g_ema_decay", fallback=None)
                snap["niter"] = c.get("TRAINING", "niter", fallback=None)

    last_it = int(max(it_g[-1] if len(it_g) else 0,
                      it_p[-1] if len(it_p) else 0))
    milestones = json.loads(snap.get("multistep_lr_steps") or "[]")
    out = {
        "run_folder": run_folder,
        "last_it": last_it,
        "niter": snap.get("niter"),
        "lr_milestones": milestones,
        "lr_milestones_crossed": [m for m in milestones if m <= last_it],
        "g_ema_decay": snap.get("g_ema_decay"),
        "checkpoints": saves,
        "val_PSNR_trajectory": _traj(it_p, psnr),
        "trilinear_PSNR_mean": round(float(np.mean(tri)), 3)
        if len(tri) else None,
        "val_PSNR_tail": _tail_stats(psnr),
        "G_total_train_tail": _tail_stats(g_tot),
        "G_adversarial_tail": _tail_stats(g_adv[g_adv != 0.0]),
        "G_val_total_tail": _tail_stats(g_val),
        "D_val_loss_trajectory": _traj(it_d, d_val),
        "D_val_loss_tail": _tail_stats(d_val),
        "G_grad_norm_tail": _tail_stats(g_norm),
        "resume_legs": None,  # filled by the caller when legs are known
    }
    return out, tb_dir


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run_folder = argv[0].rstrip("/")
    out_path = (argv[argv.index("--out") + 1] if "--out" in argv
                else os.path.join(run_folder, "longrun_summary.json"))
    summary, tb_dir = summarize(run_folder)
    fig_path = os.path.join(run_folder, "band_plot.png")
    try:
        exp_comparison_plot([tb_dir], out_path=fig_path)
        summary["band_plot"] = fig_path
    except Exception as e:  # a missing or headless matplotlib
        summary["band_plot_error"] = str(e)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
