"""Traffic kinds ``open_loop`` and ``closed_loop``: ``POST /v1/upscale``
through ``WindFieldServer`` (as ``eval/server.py:main`` builds it, bound
to 127.0.0.1 on a port the OS picks) -> ``MicroBatcher`` ->
``WindFieldSR.upscale``, loaded by ``windbench.client`` in a process of
its own.

Set-up makes G's weights from the seed, builds the backend (which builds
its kernels), runs the program's own ``warmup`` at each batch size the
micro-batcher can form for this traffic, starts the server and the
client, and ends when the client has its fields encoded and its
connections open. The backend the server gets is a thin wrapper that
times each ``upscale`` call (a span; a profiler range in a traced run).

After the window, with the server closed and the backend freed, the plain
reference recomputes the fields of a sample of the replies, drawn from the
seed, and each reply is held to it.
"""

from __future__ import annotations

import gc
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from windbench import inputs, payloads
from windbench.reference.model import Precision, generator_forward


class TimedBackend:
    """``WindFieldSR`` as the server sees it, each ``upscale`` in a span
    that carries its batch size; ``alter`` (tests) changes what it returns
    before the server sends it."""

    def __init__(self, sr, recorder, alter=None):
        self.sr, self.rec, self.alter = sr, recorder, alter
        self.scale = sr.scale
        self.norm_stats = None
        self.lr_channels = sr.lr_channels

    def upscale(self, lr, z):
        with self.rec.span("upscale", batch=int(np.shape(lr)[0])):
            out = self.sr.upscale(lr, z)
        return out if self.alter is None else self.alter(out)


def reference_fields(W_G: dict, geometry, lrs, zs, fields, device,
                     block: int, prec: Precision = Precision()) -> np.ndarray:
    """The reference's SR of pool fields ``fields``, in blocks of
    ``block`` fields: float32 (n, X, Y, Zl, 3) on the host."""
    out = []
    with torch.no_grad():
        for a in range(0, len(fields), block):
            idx = fields[a:a + block]
            lr = torch.from_numpy(lrs[idx]).to(device)
            z = torch.from_numpy(zs[idx]).to(device)
            out.append(generator_forward(W_G, lr, z, geometry, prec).cpu())
    return (torch.cat(out).numpy() if out
            else np.zeros((0,) + zs.shape[1:4] + (3,), np.float32))


def relative_errors(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each field's relative L2 error against the reference's."""
    got = got.reshape(len(got), -1).astype(np.float64)
    want = want.reshape(len(want), -1).astype(np.float64)
    return (np.linalg.norm(got - want, axis=1)
            / np.linalg.norm(want, axis=1))


def run(ctx, alter=None, int8_calibration: int = 0) -> dict:
    from gan_sr_wind_field_tpu_torch.config.config import Config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.server import serve, warmup
    from gan_sr_wind_field_tpu_torch.ops import rdb_trunk

    conf, traffic, dev = ctx.conf, ctx.traffic, ctx.device
    cfg = Config.from_ini_string(inputs.ini_text(conf))
    sp = inputs.spec(conf)
    seeds = inputs.seeds(ctx.seed)
    W = inputs.weights(conf, seeds["weights"], dev)
    g = sp.geometry
    X, Y = inputs.hr_xy(conf)
    Zl, s = g.z_layers, g.scale
    lr_field = (X // s, Y // s, Zl)
    sr = WindFieldSR(cfg, W["G"], device=dev)
    if int8_calibration:
        # the program's own lower-precision path (the control)
        calib, _ = payloads.pool(seeds["fields"] + 1, int8_calibration,
                                 X, Y, Zl, s)
        sr.quantize(calib)
        sr.quantize_trunk(calib)
    rec = ctx.recorder
    backend = TimedBackend(sr, rec, alter)
    warmup(backend, lr_field + (g.in_ch,), (X, Y, Zl, 1),
           traffic["warm_batches"])
    srv = serve(backend, host="127.0.0.1", port=0,
                max_batch=int(traffic["max_batch"]),
                max_wait_ms=float(traffic["max_wait_ms"]))
    port = srv.server_address[1]
    params = dict(traffic, seed=seeds["fields"], port=port,
                  seconds=ctx.seconds, hr=[X, Y, Zl], scale=s)
    client = subprocess.Popen(
        [sys.executable, "-m", "windbench.client", json.dumps(params)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ctx.root)
    try:
        if client.stdout.readline().strip() != b"ready":
            raise RuntimeError("the load client did not start")
        ctx.sync()
        setup_s = time.perf_counter() - ctx.t_start
        stats0 = dict(srv.batcher.stats)
        k1_0 = rdb_trunk.launches
        prof = ctx.start_profiler()
        rec.spans.clear()
        t0 = time.perf_counter()
        with rec.span("window"):
            client.stdin.write(b"go\n")
            client.stdin.flush()
            out, _ = client.communicate(
                timeout=ctx.seconds + float(traffic["drain_s"]) + 60)
            ctx.sync()
        window_s = time.perf_counter() - t0
        ops, ranges = ctx.stop_profiler(prof)
        stats1 = dict(srv.batcher.stats)
        k1 = rdb_trunk.launches - k1_0
    finally:
        srv.close()
        if client.poll() is None:
            client.kill()
        client.wait()
    peak = ctx.memory_peak()
    res = np.load(io.BytesIO(out), allow_pickle=False)
    res = {k: res[k] for k in res.files}
    vox = X * Y * Zl
    if traffic["kind"] == "open_loop":
        lat = res["lat"]
        attempted, failed = len(lat), int((~res["ok"]).sum())
        lat_ms = np.where(res["ok"], lat, np.inf) * 1e3
        # a failed request misses every limit: it sorts above every reply
        lat_ms = np.minimum(lat_ms, 1e12)
        metrics = {"serve_p50_ms": float(np.percentile(lat_ms, 50)),
                   "serve_p95_ms": float(np.percentile(lat_ms, 95))}
        third = max(len(lat_ms) // 3, 1)
        load = {"rate": traffic["rate"], "p50_ms": metrics["serve_p50_ms"],
                "p95_ms": metrics["serve_p95_ms"],
                "first_third_p50_ms": float(np.median(lat_ms[:third])),
                "last_third_p50_ms": float(np.median(lat_ms[-third:])),
                "late_max_ms": float(1e3 * res["late"].max()),
                "fields_per_s": float(res["ok"].sum() / ctx.seconds)}
        ctx.log(f"open loop: {attempted} requests due in {ctx.seconds} s at "
                f"{traffic['rate']}/s, {failed} failed; p50 "
                f"{metrics['serve_p50_ms']:.3f} ms, p95 "
                f"{metrics['serve_p95_ms']:.3f} ms; the client's "
                f"dispatcher ran late by {1e3 * np.median(res['late']):.3f} "
                f"ms (median), {1e3 * res['late'].max():.3f} ms (max)")
    else:
        inside = res["end"] <= ctx.seconds
        attempted = int((res["start"] < ctx.seconds).sum())
        failed = int((~res["ok"] & (res["start"] < ctx.seconds)).sum())
        done = int((res["ok"] & inside).sum())
        metrics = {"serve_voxels_per_s": done * vox / ctx.seconds}
        load = {"clients": traffic["clients"], "replies": done}
        ctx.log(f"closed loop: {traffic['clients']} clients, {done} replies "
                f"in {ctx.seconds} s, {attempted} sent, {failed} failed")
    metrics["setup_s"] = setup_s
    counters = {k: stats1[k] - stats0[k] for k in
                ("requests", "batches", "batched_samples", "padded_samples")}
    counters["trunk_launches"] = k1
    spans = [sp_ for sp_ in rec.spans if sp_.name == "upscale"]
    cell = {"geometry": g, "lr_field": lr_field,
            "trunk_calls": [(sp_.attrs["batch"] * lr_field[0] * lr_field[1]
                             * Zl, False) for sp_ in spans]}

    del backend, sr, srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lrs, zs = payloads.pool(seeds["fields"], int(traffic["pool"]), X, Y, Zl,
                            s)
    want = reference_fields(W["G"], g, lrs, zs, res["sample_field"], dev,
                            int(traffic["check_block"]))
    errs = relative_errors(res["sr"], want)
    checks = {"field_err": float(errs.max()) if len(errs) else float("inf"),
              "missing": float(res["sample_missing"])}
    ctx.log(f"checked {len(errs)} replies against the reference: relative "
            f"L2 median {np.median(errs) if len(errs) else float('nan'):.4e}"
            f", max {checks['field_err']:.4e}")
    return {"metrics": metrics, "attempted": attempted, "failed": failed,
            "checks": checks, "memory_peak_bytes": peak,
            "window_s": window_s, "ops": ops, "ranges": ranges,
            "spans": rec.spans, "counters": counters, "cell": cell,
            "load": load, "want": want,
            "inputs": (W["G"], g, lrs, zs, res["sample_field"], dev,
                       int(traffic["check_block"]))}
