"""The readings a cell's check limits are set from, on the card, in one
process (the benchmark's own runs never run this):

    python3 -m windbench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3

For each seed it drives a run of the cell (a short window at the cell's
own load) and prints each number the check compares: the program's
readings, whose largest over a dozen seeds or more is the lower reading of
each limit. For each control seed it prints the control's readings, whose
smallest is the upper one: the reference itself with every conv and linear
layer's operands rounded to fp8 (e4m3, per-tensor scale), in the
program's place. ``--int8-seeds`` reads the program's own int8 serving
path (``WindFieldSR.quantize`` and ``quantize_trunk``, calibrated on 8
fields) on a serving cell, and ``--fault-seeds`` a training cell with a
fault planted in the program's step (``FAULTS``). Each line is a JSON
object: the readings, and ``correct`` as the cell's limits
(``windbench/limits/<cell>.json``) judge them, as a run judges its own.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from windbench import drive_serve, inputs
from windbench import run as wb_run
from windbench.drive_train import compare, reference_readings
from windbench.reference.model import Precision
from windbench.reference.train import run_steps


def unchanged_state(orig):
    """A step that returns its state unchanged (its losses computed)."""
    def step(self, state, lr, hr, z, augment=False, weights=None):
        trees = [state.params_G, state.params_G_ema, state.params_D,
                 state.opt_state_G.mu, state.opt_state_G.nu,
                 state.opt_state_D.mu, state.opt_state_D.nu]
        saved = [{k: v.clone() for k, v in t.items()} for t in trees]
        state, metrics = orig(self, state, lr, hr, z, augment, weights)
        for t, s in zip(trees, saved):
            for k in t:
                t[k].copy_(s[k])
        return state, metrics
    return step


def half_batch(orig):
    """A step on the first half of its batch, the mean over those rows."""
    def step(self, state, lr, hr, z, augment=False, weights=None):
        n = lr.shape[0] // 2
        return orig(self, state, lr[:n], hr[:n], z[:n], augment, weights)
    return step


FAULTS = {"state-unchanged": unchanged_state, "half-batch": half_batch}


def readings(bench, workload, seed, seconds, device, side: str) -> dict:
    ctx = wb_run.Context(bench, workload, seed, seconds, False, device)
    kind = ctx.traffic["kind"]
    driver = importlib.import_module(f"windbench.drive_{kind}")
    if side.startswith("fault:"):
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        orig = WindFieldGAN.train_step
        WindFieldGAN.train_step = FAULTS[side[6:]](orig)
        try:
            return driver.run(ctx)["checks"]
        finally:
            WindFieldGAN.train_step = orig
    if side == "int8":
        return driver.run(ctx, int8_calibration=8)["checks"]
    out = driver.run(ctx)
    if side == "program":
        return out["checks"]
    if kind != "train":
        W_G, g, lrs, zs, fields, dev, block = out["inputs"]
        low = drive_serve.reference_fields(W_G, g, lrs, zs, fields, dev,
                                           block, Precision(fp8=True))
        errs = drive_serve.relative_errors(low, out["want"])
        return {"field_err": float(errs.max()), "missing": 0.0}
    sp, W, data, seeds, start_it, n, before = out["inputs"]
    low = run_steps(sp, W, data, seeds, start_it, n, Precision(fp8=True))
    return compare(reference_readings(low, before), out["reference"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--int8-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--fault", default="half-batch", choices=sorted(FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = json.loads((wb_run.ROOT / "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    limits = inputs.load_json("limits", args.workload)
    for label, seeds in (("program", args.seeds),
                         ("control", args.control_seeds),
                         ("int8", args.int8_seeds),
                         (f"fault:{args.fault}", args.fault_seeds)):
        for s in filter(None, seeds.split(",")):
            r = readings(bench, args.workload, int(s), args.seconds, device,
                         label)
            _, correct = wb_run.judge(r, limits)
            print(json.dumps({"workload": args.workload, "side": label,
                              "seed": int(s), **r, "correct": correct}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
