"""Traffic kind ``train``: ``WindFieldGAN.train_step`` on device-resident
batches, driven as ``train/loop.py:train`` drives it with one step per
dispatch (``batches.count = it``, the next batch, ``train_step`` with the
augmentation on the card), for the window, with no validation, save or
log boundary inside it.

Set-up makes the weights and the volumes from the seed, builds the trainer
and its state, writes the weights into it, and drives that state through
its first ``checked_steps`` iterations through the same call and feed
(they also warm every shape the window runs). From those steps it keeps
what the check compares: each step's loss, the first gradient of G and of
D as Adam got it (its first moment over 1 - beta1), and each leaf's change
after the steps. The same state then runs the window. After the window,
with the program's state freed, the plain reference follows the checked
steps from the same weights, volumes and seeds.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from windbench import inputs
from windbench.reference.model import Precision
from windbench.reference.train import is_g_step, run_steps


def _leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tree.items()}


def _change_norms(after: dict, before: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(after[k].float()
                                              - before[k].float()))
            for k in before}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def worst_leaf_gap(prog: dict, ref: dict, keep=None):
    """(The largest gap between the program's norm of a leaf and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; that leaf's name)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = _median([ref[k] for k in keys])
    gaps = [(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
            for k in keys]
    return max(gaps) if gaps else (0.0, "")


def compare(readings: dict, ref: dict, where=None) -> dict:
    """The three numbers the check holds to their limits; ``where``, a
    dict, gets the leaf that sets each of the last two."""
    losses = readings["losses"]
    loss = max(abs(p - r) / max(abs(r), 1e-12)
               for p, r in zip(losses, ref["losses"]))
    grad, change = (0.0, ""), (0.0, "")
    for group in ("G", "D"):
        if group not in ref["first"]:
            continue
        rg = _leaf_norms(ref["first"][group])
        grad = max(grad, worst_leaf_gap(readings["first"][group], rg))
        # leaves whose reference gradient is nought to rounding move by
        # Adam's round-off alone: left out by this rule, not by name
        med = _median(list(rg.values()))
        moved = {k for k, v in rg.items() if v >= 1e-3 * med}
        for tree in ((group, "G_ema") if group == "G" else (group,)):
            rc = _change_norms(ref["after"][tree], readings["before"][tree])
            gap, leaf = worst_leaf_gap(readings["change"][tree], rc, moved)
            change = max(change, (gap, f"{tree}:{leaf}"))
    if where is not None:
        where.update(grad=grad[1], change=change[1])
    return {"loss": loss, "grad": grad[0], "change": change[0]}


def resident_batcher(full, zraw, batch_size, slice_size, enable_slicing,
                     cf, seed, start_count):
    """A ``DeviceBatcher`` over volumes already on the device: its
    iteration as the loop uses it, without its constructor, which reads a
    dataset from disk (the benchmark makes the volumes itself)."""
    from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher

    b = DeviceBatcher.__new__(DeviceBatcher)
    b.batch_size, b.rows = int(batch_size), None
    b.slice_size, b.enable_slicing = int(slice_size), bool(enable_slicing)
    b.cf, b.device = int(cf), full.device
    b.seed, b.count = int(seed), int(start_count)
    b.full, b.zraw = full, zraw
    X, Y = full.shape[1:3]
    b.patch = b.slice_size if b.enable_slicing else X
    b.patch_y = b.slice_size if b.enable_slicing else Y
    b._gen = torch.Generator(device=full.device)
    return b


def reference_readings(out: dict, before: dict) -> dict:
    """``run_steps``'s output in the form of the program's readings (the
    control's, where a lower precision takes the program's place)."""
    return {"losses": out["losses"],
            "first": {g: _leaf_norms(t) for g, t in out["first"].items()},
            "change": {t: _change_norms(out["after"][t], before[t])
                       for t in before},
            "before": before}


def run(ctx) -> dict:
    from gan_sr_wind_field_tpu_torch.config.config import Config
    from gan_sr_wind_field_tpu_torch.ops import rdb_trunk, stencil
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    conf, traffic, dev = ctx.conf, ctx.traffic, ctx.device
    cfg = Config.from_ini_string(inputs.ini_text(conf))
    sp = inputs.spec(conf)
    seeds = inputs.seeds(ctx.seed)
    W = inputs.weights(conf, seeds["weights"], dev)
    data = inputs.volumes(conf, seeds["data"], dev)
    gan = WindFieldGAN(cfg, data["x"].cpu().numpy(), data["y"].cpu().numpy(),
                       device=dev)
    B, X, Y = sp.batch, len(data["x"]), len(data["y"])
    Zl = sp.geometry.z_layers
    lr_shape = (B, X // sp.cf, Y // sp.cf, Zl)
    hr_shape = (B, X, Y, Zl)
    state = gan.init_state(seeds["weights"], lr_shape + (sp.geometry.in_ch,),
                           hr_shape + (3,))
    with torch.no_grad():
        for k, v in W["G"].items():
            state.params_G[k].copy_(v)
            state.params_G_ema[k].copy_(v)
        for k, v in W["D"].items():
            state.params_D[k].copy_(v)
        for k, v in W["D_stats"].items():
            state.batch_stats_D[k].copy_(v)
    state.rng.manual_seed(seeds["rng"])
    start_it = int(traffic["start_it"])
    state.it = start_it
    sec = conf["sections"]
    batches = resident_batcher(data["full"], data["zraw"], B,
                        sec["GAN"]["slice_size"], sec["GAN"]["enable_slicing"],
                        sp.cf, seeds["stream"], start_it)
    it = start_it
    rec = ctx.recorder

    def step(timed: bool):
        nonlocal state, it
        batches.count = it
        batch = next(batches)
        it += 1
        kind = "g_step" if gan.is_g_step(it) else "d_step"
        if not timed or dev.type != "cuda":
            with rec.span(kind) if timed else contextlib.nullcontext():
                state, metrics = gan.train_step(state, *batch, augment=True)
            return kind, metrics
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with rec.span(kind) as attrs:
            e0.record()
            state, metrics = gan.train_step(state, *batch, augment=True)
            e1.record()
        attrs["events"] = (e0, e1)
        return kind, metrics

    readings = {"losses": [], "first": {}, "change": {}, "before": {}}
    for _ in range(int(traffic["checked_steps"])):
        kind, metrics = step(False)
        readings["losses"].append(float(metrics["total"] if kind == "g_step"
                                        else metrics["D_train_loss"]))
        group = "G" if kind == "g_step" else "D"
        if group not in readings["first"]:
            opt = state.opt_state_G if group == "G" else state.opt_state_D
            beta1 = sp.beta1_g if group == "G" else sp.beta1_d
            readings["first"][group] = {
                k: float(torch.linalg.vector_norm(m.float())) / (1 - beta1)
                for k, m in opt.mu.items()}
    for tree, now in (("G", state.params_G), ("G_ema", state.params_G_ema),
                      ("D", state.params_D)):
        before = W["D" if tree == "D" else "G"]
        readings["before"][tree] = before
        readings["change"][tree] = _change_norms(now, before)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    launches0 = (rdb_trunk.launches, rdb_trunk.bwd_launches,
                 stencil.launches, stencil.adjoint_launches)
    prof = ctx.start_profiler()
    rec.spans.clear()
    t0 = time.perf_counter()
    n_steps = 0
    with rec.span("window"):
        while time.perf_counter() - t0 < ctx.seconds:
            step(True)
            n_steps += 1
        ctx.sync()
    window_s = time.perf_counter() - t0
    ops, ranges = ctx.stop_profiler(prof)
    for s in rec.spans:
        if "events" in s.attrs:
            e0, e1 = s.attrs.pop("events")
            s.attrs["ms"] = e0.elapsed_time(e1)
    n_g = sum(1 for s in rec.spans if s.name == "g_step")
    n_d = n_steps - n_g
    k1, k2, k3, k4 = (a - b for a, b in zip(
        (rdb_trunk.launches, rdb_trunk.bwd_launches, stencil.launches,
         stencil.adjoint_launches), launches0))
    rows = B * lr_shape[1] * lr_shape[2] * Zl
    peak = ctx.memory_peak()
    cell = {"geometry": sp.geometry, "lr_shape": lr_shape,
            "hr_shape": hr_shape, "hr_voxels": B * X * Y * Zl,
            "adversarial": sp.w_adv != 0.0 or sp.ratio > 0,
            "trunk_calls": [(rows, True)] * n_g + [(rows, False)] * n_d}
    counters = {"trunk_launches": k1, "trunk_bwd_launches": k2,
                "stencil_launches": k3, "adjoint_launches": k4,
                "g_steps": n_g, "d_steps": n_d}
    metrics = {"train_voxels_per_s": n_steps * B * X * Y * Zl / window_s,
               "setup_s": setup_s}

    del state, gan, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_checked = int(traffic["checked_steps"])
    ref = run_steps(sp, W, data, seeds, start_it, n_checked, Precision())
    where = {}
    checks = compare(readings, ref, where)
    steps = [("G" if is_g_step(sp, i) else "D")
             for i in range(start_it + 1,
                            start_it + n_checked + 1)]
    ctx.log(f"checked steps {start_it + 1}..{it - n_steps} ({''.join(steps)}):"
            f" losses {readings['losses']} against the reference's "
            f"{ref['losses']}; worst leaves: first gradient {where['grad']}, "
            f"change {where['change']}")
    return {"metrics": metrics, "attempted": n_steps, "failed": 0,
            "checks": checks, "memory_peak_bytes": peak,
            "window_s": window_s, "ops": ops, "ranges": ranges,
            "spans": rec.spans, "counters": counters, "cell": cell,
            "reference": ref, "inputs": (sp, W, data, seeds, start_it,
                                         n_checked, readings["before"])}
