#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve the full-width 4x generator on
one NVIDIA card through the hand-written RRDB-trunk kernel.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA source of the port (one nvcc call each, in parallel);
  3. the trunk kernel against its plain PyTorch version at full width
     (16 RRDB x 3 RDB, nf=128, gc=32, batch 2, LR 16x16x10, weights at
     init scale 1.0): relative L2 error of the increment trunk(x) - x,
     float32 <= 1e-4 (TF32 off), bfloat16 kernel vs float32 plain <= 3e-2,
     and vs bfloat16 plain on the same inputs <= 3e-2;
  4. serve configs/milestone9k.ini (seeded random weights, bf16) through
     WindFieldServer on 127.0.0.1: 4 single-sample and one 8-sample HTTP
     request plus 6 concurrent MicroBatcher.submit calls; every output
     (64, 64, 10, 3) and finite, and the trunk kernel's launch count rose;
     then one batch against the same model with the plain trunk, <= 3e-2;
  5. CUDA-event times (1 warm-up, 5 repeats) at batch 8: the kernel, its
     plain version, a bf16 cuDNN chain computing the same trunk, and the
     serving forward with each of its layers timed alone.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

T0 = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "configs", "milestone9k.ini")
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
TIMEOUT_S = 120.0


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def rel_l2(a, b):
    import torch

    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double())).item()


def cuda_ms(fn, reps=5):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cudnn_trunk(weights, x, per=3, rdb_scale=0.2, rrdb_scale=0.2, slope=0.2):
    """The same trunk as one cuDNN call per conv in bfloat16 (the library
    yardstick for `library_ms`; the port never calls this)."""
    import torch
    import torch.nn.functional as F

    s1 = torch.tensor(rdb_scale, dtype=x.dtype, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=x.dtype, device=x.device)
    state = x.permute(0, 4, 1, 2, 3)
    rres = state
    for j, (convs, w_lff, b_lff) in enumerate(weights):
        if j % per == 0:
            rres = state
        feats = state
        for w in convs:
            y = F.leaky_relu(F.conv3d(feats, w, padding=1), slope)
            feats = torch.cat([feats, y], dim=1)
        new = state + F.conv3d(feats, w_lff, b_lff) * s1
        if j % per == per - 1:
            new = rres + new * s2
        state = new
    return state.permute(0, 2, 3, 4, 1)


def serving_stages(sr, lr, z, geom):
    """(name, ms) of each layer of the serving forward, timed alone on
    the inputs the forward gives it (models/fused_apply.py order)."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import rrdb_trunk
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy

    G = sr.G
    stages = []
    with torch.inference_mode():
        lr = lr.to(G.dtype)
        f = G.feature_conv(lr)
        stages.append(("feature_conv", lambda: G.feature_conv(lr)))
        f = f.contiguous()
        tr = rrdb_trunk(sr.packed, f, **geom)
        stages.append(("trunk kernel", lambda: rrdb_trunk(sr.packed, f,
                                                          **geom)))
        stages.append(("lr_conv", lambda: G.lr_conv(tr)))
        h = f + G.lr_conv(tr)
        for i, up in enumerate(G.upconvs):
            h_in = upsample_nearest_xy(h, 2)
            stages.append((f"upconv{i}", lambda up=up, h_in=h_in: up(h_in)))
            h = up(h_in)
        zt = z.to(G.dtype)
        t = G.terrain_conv1(G.terrain_conv0(zt))
        stages.append(("terrain convs", lambda: G.terrain_conv1(
            G.terrain_conv0(zt))))
        stages.append(("hr_conv0_x", lambda: G.hr_conv0_x(h)))
        stages.append(("hr_conv0_t", lambda: G.hr_conv0_t(t)))
        a = F.leaky_relu(G.hr_conv0_x(h) + G.hr_conv0_t(t), G.negative_slope)
        stages.append(("hr_conv1", lambda: G.hr_conv1(a)))
        return [(name, cuda_ms(fn)) for name, fn in stages]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, REPO)
    import numpy as np

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.server import serve
    from gan_sr_wind_field_tpu_torch.models.blocks import RRDB
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
    )
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.ops import rdb_trunk
    from gan_sr_wind_field_tpu_torch.ops.kernels import build
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        rrdb_trunk,
        rrdb_trunk_reference,
    )

    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    t = time.monotonic()
    for name, (path, secs, report) in build.build().items():
        log(f"built {name}: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total {time.monotonic() - t:.1f} s")

    # ------------------------------------------- 3. kernel vs plain version
    cfg = load_config(CFG)
    g = cfg.generator
    nf, gc, nconv = g.num_features, g.RDB_growth_chan, g.num_RDB_convs
    geom = dict(gc=gc, num_convs=nconv, rdb_scale=g.RDB_res_scaling,
                rrdb_scale=g.RRDB_res_scaling, negative_slope=0.2)
    lr_xy = cfg.gan_config.slice_size // cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    gen = torch.Generator().manual_seed(2001)
    rrdbs = [RRDB(nf, gc, num_convs=nconv, init_scale=1.0, generator=gen)
             for _ in range(g.num_RRDB)]
    for r in rrdbs:
        for rdb in r.rdbs:  # non-zero LFF bias, so its path is checked
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    p32 = pack_trunk_weights(rrdbs, torch.float32, dev)
    p16 = pack_trunk_weights(rrdbs, torch.bfloat16, dev)

    got32 = rrdb_trunk(p32, x, **geom)
    want32 = rrdb_trunk_reference(p32, x, **geom)
    torch.cuda.synchronize()
    err32 = rel_l2(got32 - x, want32 - x)
    log(f"trunk fp32 kernel vs plain: rel L2 of increment {err32:.3e} "
        f"(tol 1e-4), max abs {(got32 - want32).abs().max().item():.3e}")
    if not err32 <= 1e-4:
        fail(f"fp32 trunk kernel disagrees: {err32:.3e} > 1e-4")

    x16 = x.to(torch.bfloat16)
    got16 = rrdb_trunk(p16, x16, **geom).float()
    want16 = rrdb_trunk_reference(p32, x16.float(), **geom)
    torch.cuda.synchronize()
    err16 = rel_l2(got16 - x16.float(), want16 - x16.float())
    log(f"trunk bf16 kernel vs fp32 plain: rel L2 of increment {err16:.3e} "
        f"(tol 3e-2), max abs {(got16 - want16).abs().max().item():.3e}")
    if not err16 <= 3e-2:
        fail(f"bf16 trunk kernel disagrees: {err16:.3e} > 3e-2")
    # the same bf16 inputs and weights through the plain version, whose
    # rounding points are the kernel's: the main path's own comparison
    same16 = rrdb_trunk_reference(p16, x16, **geom).float()
    err16s = rel_l2(got16 - x16.float(), same16 - x16.float())
    max_abs16 = (got16 - same16).abs().max().item()
    log(f"trunk bf16 kernel vs bf16 plain: rel L2 of increment "
        f"{err16s:.3e} (tol 3e-2), max abs {max_abs16:.3e} of "
        f"max |out| {same16.abs().max().item():.3e}")
    if not err16s <= 3e-2:
        fail(f"bf16 trunk kernel disagrees: {err16s:.3e} > 3e-2")
    del got32, want32, got16, want16, same16

    # ------------------------------------------------------------ 4. serve
    G0 = generator_from_config(cfg, device=dev, seed=2001)
    sr = WindFieldSR(cfg, G0.state_dict(), device=dev)
    del G0
    if sr.packed is None:
        fail("milestone9k geometry does not take the trunk kernel")
    rng = np.random.default_rng(2001)
    hr_xy = lr_xy * cfg.scale
    C = cfg.lr_num_channels

    def sample(n):
        lr = rng.standard_normal((n, lr_xy, lr_xy, zl, C)).astype(np.float32)
        z = np.cumsum(rng.random((n, hr_xy, hr_xy, zl, 1)), axis=3)
        return lr, (z / z.max()).astype(np.float32)

    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    outs = []
    rdb_trunk.launches = 0
    srv = serve(sr, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=20.0)
    pool = ThreadPoolExecutor(max_workers=6)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/upscale"
        for n in (None, None, None, None, 8):
            lr, z = sample(1 if n is None else n)
            if n is None:
                lr, z = lr[0], z[0]
            buf = io.BytesIO()
            np.savez(buf, lr=lr, z=z)
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
                if resp.status != 200:
                    fail(f"HTTP {resp.status}")
                out = np.load(io.BytesIO(resp.read()))["sr"]
            outs.extend([out] if n is None else list(out))
        lr, z = sample(6)
        futs = [pool.submit(srv.batcher.submit, lr[i], z[i], TIMEOUT_S)
                for i in range(6)]
        outs.extend(f.result(timeout=TIMEOUT_S + 30) for f in futs)
        stats = srv.batcher.stats_snapshot()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        srv.close()
    launches = rdb_trunk.launches
    log(f"served {len(outs)} samples in {stats['batches']} batches "
        f"(max batch {stats['max_batch_seen']}, errors {stats['errors']}); "
        f"trunk kernel launches {launches}")
    for o in outs:
        if o.shape != (hr_xy, hr_xy, zl, 3) or not np.isfinite(o).all():
            fail(f"bad output: shape {o.shape}, "
                 f"finite {bool(np.isfinite(o).all())}")
    if len(outs) != 18 or launches < 1 or stats["errors"]:
        fail(f"{len(outs)} outputs, {launches} kernel launches, "
             f"{stats['errors']} batch errors")

    lr, z = sample(8)
    lr_d, z_d = torch.from_numpy(lr).to(dev), torch.from_numpy(z).to(dev)
    got = torch.from_numpy(sr.upscale(lr, z))
    with torch.inference_mode():
        want = generator_forward(
            sr.G, lr_d, z_d,
            lambda f: rrdb_trunk_reference(sr.packed, f.contiguous(), **geom),
        ).cpu()
    err_srv = rel_l2(got, want)
    log(f"serving output, kernel trunk vs plain trunk: rel L2 {err_srv:.3e} "
        f"(tol 3e-2)")
    if not err_srv <= 3e-2:
        fail(f"served output disagrees with the plain trunk: {err_srv:.3e}")

    # ------------------------------------------------------------ 5. times
    xb = torch.randn(8, lr_xy, lr_xy, zl, nf, generator=gen).to(
        dev, torch.bfloat16)
    kw = dict(geom)
    ms = cuda_ms(lambda: rrdb_trunk(sr.packed, xb, **kw))
    plain_ms = cuda_ms(lambda: rrdb_trunk_reference(sr.packed, xb, **kw))
    lib_w = []
    for r in sr.G.rrdbs:
        for rdb in r.rdbs:
            lib_w.append((
                [c.weight.detach().to(torch.bfloat16) for c in rdb.convs],
                rdb.lff.weight.detach().to(torch.bfloat16),
                rdb.lff.bias.detach().to(torch.bfloat16),
            ))
    with torch.inference_mode():
        lib_ms = cuda_ms(lambda: cudnn_trunk(lib_w, xb))
        fwd_ms = cuda_ms(lambda: sr._generate(lr_d, z_d))
    vox = 8 * hr_xy * hr_xy * zl
    log(f"trunk kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN bf16 "
        f"chain {lib_ms:.3f} ms per batch-8 forward ({card})")
    log(f"serving forward {fwd_ms:.3f} ms per batch of 8, "
        f"{vox / (fwd_ms / 1e3):.4e} HR voxels/s ({card})")
    for name, stage_ms in serving_stages(sr, lr_d, z_d, geom):
        log(f"  stage {name:<13} {stage_ms:9.3f} ms "
            f"{100 * stage_ms / fwd_ms:5.1f} % of the forward")

    rows = xb.shape[0] * lr_xy * lr_xy * zl
    J = 3 * g.num_RRDB
    K = nconv - 1
    macs = rows * J * (27 * gc * sum(nf + gc * k for k in range(K))
                       + (nf + gc * K) * nf)
    nbytes = 2 * (2 * xb.numel() + sum(t.numel() for t in sr.packed.values()))
    t_ops = 2 * macs / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    log(f"bound: {2 * macs:.4e} FLOP -> {t_ops:.4f} ms, {nbytes:.4e} B -> "
        f"{t_bytes:.4f} ms")
    table = {"kernels": [{
        "name": "rrdb_trunk",
        "route": "cuda",
        "source": "gan_sr_wind_field_tpu_torch/ops/kernels/csrc/rdb_trunk.cu",
        "replaces": "gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py:178",
        "launches": launches,
        "max_abs_err": max_abs16,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
    }]}
    if not all(math.isfinite(v) for v in (ms, plain_ms, lib_ms, fwd_ms)):
        fail("a timing is not finite")
    log(f"total {time.monotonic() - T0:.1f} s")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
