#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve, train and evaluate the
full-width 4x generator on one NVIDIA card through the hand-written CUDA
kernels, train in chunks of CUDA graphs, SR a field of any extent, and
deploy it: int8 serving, the torch.export artifact, interpolation.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --stencils-of ROOT   # kernels 3 and 4 of ROOT only

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA source of the port (one nvcc call each, in parallel),
     with each one's seconds and ptxas registers and spills; for the bf16
     kernels on the tensor cores (the trunk's tc_growth_fwd, tc_lff_fwd,
     tc_growth_bwd, tc_lff_bwd and the HR head's tc_head5, tc_head3) their
     ptxas report and the HMMA/HGMMA instructions cuobjdump -sass finds in
     each (a count of 0 fails, and so does no HGMMA in the head's, whose
     tile issues wgmma);
  3. each kernel against its plain PyTorch version at full width (16 RRDB
     x 3 RDB, nf=128, gc=32, batch 2, LR 16x16x10, weights at init scale
     1.0, non-zero LFF bias), float32 with TF32 off and bfloat16 against
     the bfloat16 plain version on the same inputs: the trunk forward
     (increment trunk(x) - x, float32 <= 1e-4, bf16 <= 3e-2, and bf16 vs
     the float32 plain version <= 3e-2), its residual mode (out, states,
     growths) and the trunk backward (d_x, dU, dLFF) at the same limits;
     the trainable trunk's weight and input gradients against autograd of
     the plain trunk, float32: its backward on the plain forward's
     residuals <= 1e-4, end to end <= 2e-3; the gradient stencil and its
     adjoint at the training shape (32, 64, 64, 10, 3) with a
     terrain-following Z, <= 1e-5, and the adjoint identity to 1e-5; the
     HR head (batch 2, HR 64x64x10, 128 + 16 channels -> 144, k = 5,
     about 10 % of the channels dropped) float32 <= 1e-4, bf16 <= 1e-2
     (also at batch 32), and HRHead's four gradients against autograd,
     float32: its backward on the plain output <= 1e-4, end to end
     <= 5e-3;
  4. serve configs/milestone9k.ini (seeded random weights, bf16) through
     WindFieldServer on 127.0.0.1: 4 single-sample and one 8-sample HTTP
     request plus 6 concurrent MicroBatcher.submit calls; every output
     (64, 64, 10, 3) and finite, the trunk kernel's launch count rose and
     the head kernel's did not; then one batch against the same model
     with the plain trunk, <= 3e-2; then a copy with
     use_pallas_head_nograd serves one batch of 8 through the head kernel
     (one launch), within 3e-2 of the module head;
  5. train configs/milestone9k.ini as it stands (seeded weights at the
     config's init scales, bf16, batch 32): one G step's gradients through
     the kernels against the same step with the RRDB modules and the plain
     stencil (<= 5e-2 relative L2), and, to split that gap, against the
     same step with autograd through the trunk's plain version, then
     stage by stage on that step's trunk input and output cotangent
     (residual mode, backward, dW stage, printed);
     then from it = 47 four train_steps (48, 49 G; 50, 51 D) and one
     val_step: finite losses and metrics, G and its EMA move on G steps
     only, D and its batch statistics on D steps only, and each kernel's
     launch count rises by what one step predicts (no head launches);
     then the same on a copy with use_pallas_head, after its G step's
     gradients against the module head's (<= 2e-2);
  6. CUDA-event times (1 warm-up, 5 repeats; 2 for a call over 0.2 s):
     the serving forward at batch
     8 with each layer alone, the trunk kernel, its plain version and a
     bf16 cuDNN chain; at batch 32 the G and D steps with their parts
     (the rest of the G step split into its layers, D, losses and Adam),
     and each training kernel beside its plain version, its bound and a
     bf16 cuDNN/cuBLAS chain (for the residual mode one that keeps its
     states and growths); the stencil pair (kernels 3 and 4) with the
     card's own time per launch under torch.profiler, with the L2 warm and
     cold (a 128 MiB scratch read before each launch), beside the event
     time of 5 calls through the wrapper. The trunk kernels and their
     library chains are timed in turns, kernel-library-library-kernel over
     3 rounds, and the medians kept (serving at batch 8, residual mode and backward at 32),
     and one call of each under torch.profiler splits its time by kernel
     against the time the card waits on the host loop.
     Before they are timed, the residual mode and
     the trunk backward are held against their bf16 plain versions at
     batch 32 on the trunk input of a training batch (<= 3e-2), with the
     count of growths on the other side of 0. Then the bf16 head kernel
     against its bf16 plain version at batch 32 on the head's input of a
     training batch (<= 1e-2), its time at batch 8 and 32 beside its plain
     version, bound and bf16 cuDNN (with cudnn.benchmark off and on; the
     kernel is compared with the faster), the time of the head's cuDNN
     backward (hr_head_vjp) at batch 32, and the head path's serving
     forward and G and D steps;
  7. train as a user does: python -m gan_sr_wind_field_tpu_torch.run
     --train --synthetic --synthetic_hours 240 --synthetic_size 128 (its
     main, in process) on a copy of configs/milestone9k.ini in a temporary
     directory, with log_period 4, val_period 8, save_model_period 8,
     keep_checkpoints 2 and d_g_train_period 4 and all else as committed
     (bf16, batch 32, device-resident data, on-card augmentation, the warm
     start from the 6k pack), to --max_steps 6016: the data feed's parts
     timed alone first (synthetic cache, preprocess, npcache, resident
     volumes, upload; one slice_batch + augment_batch at batch 32); then
     the leg starts at it 6000, logs finite losses at 6004..6016,
     validates at 6008 and 6016, keeps ckpt_6008 and ckpt_6016, and each
     kernel's launches equal what its G steps, D steps, validation batches
     and generate calls predict; the loop's steady-state G and D step
     (CUDA events from one step's start to the next, iterations without
     boundary work) beside phase 6's bare train_step, a validation sweep
     and a checkpoint save with its bytes; restore_checkpoint(ckpt_6016)
     equals the live state bit for bit, the generator's state included;
     a second leg resumed from a copy of ckpt_6008 to 6016, each tree's
     largest difference from the first leg printed (bit-exact, or within
     1e-3 relative L2 where the card's step is not deterministic);
  8. evaluate, use and serve what the port trains, in phase 7's temporary
     directory on its data: pack_from_state of the live state at 6016 in
     float32 and bf16 (in two threads, beside the rest of phase 8), read
     back bit for bit (bf16: the state rounded by
     torch); WindFieldSR.from_checkpoint(ckpt_6016) serves a batch of 8
     (one trunk launch), equal bit for bit to gan.generate with the
     state's EMA, and eval/server.py's main with --checkpoint builds the
     same backend;
     then python -m gan_sr_wind_field_tpu_torch.run --test, --test
     --test_ema and --use (its main, in process, in a temporary working
     directory) on a copy of configs/test_milestone6k.ini whose weights are
     docs/evidence/milestone6k_continuation_6000.npz: 23 rows per metrics
     CSV, the two averages rows, trilinear PSNR within 1e-3 dB and raw G
     and EMA within 0.3 dB of the JAX package's committed result on a TPU
     (docs/evidence/milestone6k_test_averages.csv; raw G above trilinear),
     the largest per-field PSNR gap printed; the trunk kernel on the
     trunk input of the first test field (batch 1 at LR 32x32x10) against
     its plain version (increment <= 3e-2); the same --test on a copy with
     use_pallas_head_nograd (23 head launches, average PSNR within 0.05 dB
     and each field's SR within 3e-2 relative L2 of the module head's);
     --use writes 23 finite LR/SR dumps; each pass launches the trunk
     kernel once per generate call; times of one 128x128x10 generate with
     either head and each pass's wall seconds;
  9. the long runs' loop and SR of any extent, in phase 7's temporary
     directory on its data: (a) phase 7's leg with steps_per_dispatch 4
     and --profile, 6000 -> 6008 in two chunks (6001-6004 G, G, G, D;
     6005-6008 D, D, D, G) through CUDA graphs of the step, each kind
     warmed up and captured on its first use and then replayed (6
     replays): launches (10, 4, 10, 4, 0) with the replays counted, the
     state at 6008 against phase 7's ckpt_6008 tree by tree (bit-exact,
     or within 1e-3 relative L2), the capture seconds, the pool's bytes,
     the chunked loop's G and D step beside phase 7's, and from the trace
     the card's busy share over the window, the top 5 device operations
     and the names of kernels 1-4; (b) the host data path
     (device_resident_data off), 6000 -> 6004 per step: launches (4, 3, 6,
     3, 0), finite losses, the G step beside phase 7's and the seconds the
     loop waited on the prefetch queue; (c) WindFieldSR.upscale_tiled of
     the 6k pack at tile 16 (the server's), overlap 4, batch 8: the first
     test field of phase 8 (9 tiles, 2 batches) against _upscale_tiled_host
     (<= 1e-6 relative L2) and a direct upscale (median error over the
     standard deviation <= 0.25, JAX's bound), then a 512x512x10 field
     (121 tiles, 16 batches) with the module head and through kernel 5,
     its ms, HR voxels/s and one trunk (and head) launch per batch.
  10. deploy what the port trains, in phase 7's temporary directory on
     its data with a copy of configs/test_milestone6k.ini and the 6k pack:
     (a) the int8 conv kernels (conv_int8.cu, int8 wgmma): their ptxas
     report and IGMMA count (0 fails), each entry point bit for bit
     against its plain version (float64 F.conv3d and the epilogue's float
     ops) at the full-width shape it serves: the last growth conv 224->32
     requantized into columns 224..255 of its RDB buffer and the LFF
     256->128 with bias at LR 16x16x10 batch 8 (the LFF beside
     torch._int_mm on its operands, which must give its int32 sums), the
     head pair (5x5x5 128->128 in bf16 and 1x1x5 128->400 partials, one
     launch) at HR 64x64x10 batch 8, each timed beside its bound at 1979
     TOPS; whether F.conv3d takes int8 on the card; the head pair at
     batch 8 and 32 beside its bound, its plain version, bf16 cuDNN of
     hr_conv0_x and kernel 5; (b) run.py --serve 0 --serve_int8 8
     --serve_int8_trunk 8 (its main, with eval.server.serve replaced to
     keep the backend) calibrates on the first 8 test fields; one batch
     of 8 other test fields through the exact bf16 path, the int8 head,
     the int8 trunk and both, within JAX's 2e-2 / 3e-2 / 4e-2 relative L2
     of the exact path, their PSNR against it, their launches as
     predicted (trunk kernel / conv_int8: (1, 0), (1, 1), (0, 240), (0,
     241)), every entry point launched, each int8 path's output equal bit
     for bit to the same batch through the entry points' plain versions
     on the card, and each path's serving ms at batch 8 and 32 beside kernel
     5's; (c) run.py --export writes the artifact (bytes, export
     seconds); eval/server.py --artifact builds its ExportedSR on the
     card (seconds); at batch 1 and 8 it is within 1e-5 of WindFieldSR's
     plain path and 3e-2 of the kernel path, launching no kernel; its
     serving ms beside the kernel path's; a subprocess importing only
     torch, json and struct runs the payload (1e-5); (d) eval.interp
     blends the 9k and 6k packs: alpha 1 and 0 reproduce each pack's
     generator tensor by tensor, alpha 0.5 writes an artifact that
     serves a finite batch within 1e-5 of the blend's plain path.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.

--stencils-of ROOT builds, checks (phase 3) and times (phase 6) only the
stencil pair of the port in the checkout at ROOT, and prints no result
line: two checkouts are compared by running it for each, in turns, in one
run on one card.
"""

import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

T0 = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "configs", "milestone9k.ini")
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # CUDA-core float32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
TIMEOUT_S = 120.0
CSRC = "gan_sr_wind_field_tpu_torch/ops/kernels/csrc"
TPU = "gan_sr_wind_field_tpu/ops/pallas"
# one step's launches of (trunk, trunk backward, gradient, adjoint, head)
# on milestone9k as committed (head flags off) and with use_pallas_head
G_STEP_LAUNCHES = (1, 1, 2, 1, 0)
D_STEP_LAUNCHES = (1, 0, 0, 0, 0)
G_STEP_LAUNCHES_HEAD = (1, 1, 2, 1, 1)
D_STEP_LAUNCHES_HEAD = (1, 0, 0, 0, 1)
LAUNCH_LABELS = "trunk/bwd/gradient/adjoint/head"
# the bf16 kernels on the tensor cores, by library: the trunk's tiles
# (trunk_mma.cuh) and the HR head's (head_mma.cuh, k = 5 and k = 3)
TC_KERNELS = {"rdb_trunk": ("tc_growth_fwd", "tc_lff_fwd"),
              "rdb_trunk_bwd": ("tc_growth_bwd", "tc_lff_bwd"),
              "hr_head": ("tc_head5", "tc_head3")}
# the tensor-core instruction each library's tiles issue
TC_MMA = {"rdb_trunk": "mma.sync", "rdb_trunk_bwd": "mma.sync",
          "hr_head": "wgmma"}
TURN_ROUNDS = 3
LONG_CALL_S = 0.2  # see cuda_ms
VERY_LONG_CALL_S = 0.4
# the card's names of kernels 3 and 4 (substrings of the profiler's keys)
STENCIL_KERNELS = {"gradient": "grad_fwd", "adjoint": "grad_adj"}
# the scratch read before a cold-L2 launch: 128 MiB, over twice the L2
FLUSH_BYTES = 128 << 20
# limits set from measurements, reasons in PERF.md (section 6): the trainable
# trunk end to end, float32 (5.5e-4 measured, from LeakyReLU sign flips of
# pre-activations within rounding of 0), and one G step's bf16 gradients,
# kernels vs the module path (2.2e-2 measured; 1.0e-2 against autograd of
# the trunk's plain version, the rest the RRDB modules' own rounding)
TRAINABLE_TOL = 2e-3
G_GRAD_TOL = 5e-2
# HRHead's gradients end to end, float32 (7.843e-4 measured, from 6 of
# 11.8M head pre-activations within float32 rounding of 0 that take the
# other LeakyReLU slope; its backward on the plain output is held at 1e-4);
# reasons in PERF.md (section 6)
HEAD_GRAD_TOL = 5e-3


def log(msg=""):
    print(msg, flush=True)


def phase_start(n):
    """Marks the start of phase n with the seconds since the smoke began,
    so a run shows where its time goes."""
    log(f"phase {n} starts at {time.monotonic() - T0:.1f} s")


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def rel_l2(a, b):
    import torch

    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double())).item()


def check(name, err, tol):
    log(f"  {name}: rel L2 {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        fail(f"{name} disagrees: {err:.3e} > {tol:.0e}")


def card_line():
    """The card's name and power limit as nvidia-smi gives them, logged."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def cuda_ms(fn, reps=5):
    """Mean CUDA-event ms of ``reps`` calls after one warm-up; a call whose
    warm-up took over LONG_CALL_S gets at most 2 repeats, one over
    VERY_LONG_CALL_S one (the smoke's time limit; the spread of such calls
    is about 1 %)."""
    import torch

    t0 = time.monotonic()
    fn()  # warm-up
    torch.cuda.synchronize()
    warm = time.monotonic() - t0
    if warm > VERY_LONG_CALL_S:
        reps = 1
    elif warm > LONG_CALL_S:
        reps = min(reps, 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate(kernel, library, rounds=TURN_ROUNDS):
    """A kernel and its library chain timed in turns, kernel-library-
    library-kernel, each turn as cuda_ms: (median kernel ms, median
    library ms, the kernel's and the library's turns)."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel))
        ls.append(cuda_ms(library))
        ls.append(cuda_ms(library))
        ks.append(cuda_ms(kernel))
    return statistics.median(ks), statistics.median(ls), ks, ls


def log_turns(label, turns, card):
    k_ms, l_ms, ks, ls = turns

    def each(ts):
        return ", ".join(f"{t:.3f}" for t in ts)

    log(f"{label}: kernel median {k_ms:.3f} ms ({each(ks)}), library "
        f"median {l_ms:.3f} ms ({each(ls)}); kernel "
        f"{'faster' if k_ms < l_ms else 'slower'} by "
        f"{max(k_ms, l_ms) / min(k_ms, l_ms):.2f}x ({card})")


# the card's kernels kernel_split names; any other is "other"
SPLIT_NAMES = (*TC_KERNELS["rdb_trunk"], *TC_KERNELS["rdb_trunk_bwd"],
               "bwd_prep", "bwd_add", *STENCIL_KERNELS.values(), "Memcpy",
               "Memset")
# the int8 serving paths' kernels: conv_int8's three (the head pair's
# signature holds DequantEpi too, so it comes first), kernel 1's, cuDNN's
INT8_SPLIT_NAMES = ("head_pair_kernel", "RequantEpi", "DequantEpi",
                    *TC_KERNELS["rdb_trunk"], "implicit_convolveNd",
                    "xmma_fprop", "elementwise")


def kernel_split(label, fn, card, names=SPLIT_NAMES):
    """One call of fn under torch.profiler: the card's time by kernel
    (the first of ``names`` in a kernel's name, else "other") against the
    call's CUDA-event time; what is left is the card waiting on the host
    loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    parts = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        name = next((k for k in names if k in e.key), "other")
        ms, n = parts.get(name, (0.0, 0))
        parts[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy = sum(ms for ms, _ in parts.values())
    if not busy:
        log(f"{label}: the profiler saw no device time")
        return
    log(f"{label}: {wall:.3f} ms, the card busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} %) ({card})")
    for name, (ms, n) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        log(f"    {name:<19} {n:4d} launches {ms:9.3f} ms "
            f"({1e3 * ms / n:8.1f} us each, {100 * ms / busy:5.1f} %)")


def device_ms(fn, kernel, flush=None, reps=5):
    """The card's own time per launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn (after one
    warm-up); ``flush`` runs before each call, outside the kernel's time.
    The mean over the launches the trace holds (it may miss one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0]
    n = sum(e.count for e in hits)
    if not 0 < n <= reps:
        fail(f"the profiler saw {n} launches of {kernel} in {reps} calls")
    return sum(e.self_device_time_total for e in hits) / n / 1e3


def ptxas_reports(log_text):
    """{kernel name: its ptxas lines} from an nvcc -Xptxas -v log."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.strip())
    return out


@functools.lru_cache(maxsize=None)
def sass_mma_counts(lib_path):
    """{kernel name: [HMMA, HGMMA, IMMA, IGMMA] instruction counts} in a
    built library, from cuobjdump -sass of the toolkit that built it; None
    without cuobjdump."""
    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, 0, 0, 0]
        elif fn:
            hit = re.search(r"\b(HG|H|IG|I)MMA\b", line)
            if hit:
                out[fn][("H", "HG", "I", "IG").index(hit.group(1))] += 1
    return out


def report_tc_kernels(built):
    """Phase 2 for the bf16 tensor-core kernels: each one's ptxas report and
    HMMA/HGMMA count. Returns {library: the count over its kernels}
    (None where cuobjdump is missing); fails on a count of 0, and on no
    HGMMA in a library whose tiles issue wgmma."""
    counts = {}
    for lib, names in TC_KERNELS.items():
        path, _, report = built[lib]
        ptxas = ptxas_reports(report)
        sass = sass_mma_counts(path)
        counts[lib] = None if sass is None else 0
        for name in names:
            for fn, lines in ptxas.items():
                if name in fn:
                    log(f"  {lib} {name} ptxas: {'; '.join(lines)}")
            if sass is None:
                log(f"  {lib} {name}: cuobjdump not found, no SASS count")
                continue
            hmma, hgmma = (sum(c[i] for fn, c in sass.items() if name in fn)
                           for i in (0, 1))
            n = hmma + hgmma
            log(f"  {lib} {name}: {n} HMMA/HGMMA instructions in its SASS "
                f"({hmma} HMMA, {hgmma} HGMMA)")
            if n == 0:
                fail(f"{name} has no tensor-core instruction in its SASS")
            if TC_MMA[lib] == "wgmma" and hgmma == 0:
                fail(f"{name} issues no wgmma (HGMMA) in its SASS")
            counts[lib] += n
    return counts


def counters():
    from gan_sr_wind_field_tpu_torch.train.step_graphs import launch_counts

    return launch_counts()


def reset_counters():
    from gan_sr_wind_field_tpu_torch.ops import (
        conv_int8,
        hr_head,
        rdb_trunk,
        stencil,
    )

    rdb_trunk.launches = rdb_trunk.bwd_launches = 0
    stencil.launches = stencil.adjoint_launches = 0
    hr_head.launches = 0
    conv_int8.launches = conv_int8.pair_launches = 0
    conv_int8.requant_launches = 0


def int8_launches(each=False):
    """conv_int8's launches: the head pair's, the requantizing growth
    conv's and the conv's (each), or their sum."""
    from gan_sr_wind_field_tpu_torch.ops import conv_int8

    n = (conv_int8.pair_launches, conv_int8.requant_launches,
         conv_int8.launches)
    return n if each else sum(n)


def cudnn_trunk(weights, x, per=3, rdb_scale=0.2, rrdb_scale=0.2, slope=0.2,
                keep=False):
    """The same trunk as one cuDNN call per conv in bfloat16 (the library
    yardstick for `library_ms`; the port never calls this). With ``keep``
    it also keeps every RDB's input state and growths, as the residual
    mode does, and returns (out, states, growths)."""
    import torch
    import torch.nn.functional as F

    s1 = torch.tensor(rdb_scale, dtype=x.dtype, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=x.dtype, device=x.device)
    state = x.permute(0, 4, 1, 2, 3)
    rres = state
    states, growths = [], []
    nf = x.shape[-1]
    for j, (convs, w_lff, b_lff) in enumerate(weights):
        if j % per == 0:
            rres = state
        feats = state
        for w in convs:
            y = F.leaky_relu(F.conv3d(feats, w, padding=1), slope)
            feats = torch.cat([feats, y], dim=1)
        if keep:
            states.append(state)
            growths.append(feats[:, nf:])
        new = state + F.conv3d(feats, w_lff, b_lff) * s1
        if j % per == per - 1:
            new = rres + new * s2
        state = new
    out = state.permute(0, 2, 3, 4, 1)
    return (out, states, growths) if keep else out


def cudnn_trunk_bwd(weights, growths, d_out, per=3, rdb_scale=0.2,
                    rrdb_scale=0.2, slope=0.2):
    """The trunk backward-dx (d_x, dU, dLFF) as bf16 cuDNN transposed convs
    and cuBLAS matmuls (the library yardstick for the backward kernel's
    `library_ms`; the port never calls this)."""
    import torch
    import torch.nn.functional as F

    N, X, Y, Z, nf = d_out.shape
    ds = d_out.reshape(N, -1, nf)
    pend = ds
    dU, dLFF = [], []
    for j in range(len(weights) - 1, -1, -1):
        convs, w_lff, _ = weights[j]
        gc = convs[0].shape[0]
        d_r = ds
        if j % per == per - 1:
            pend, d_r = ds, ds * rrdb_scale
        d_lff = d_r * rdb_scale
        d_cat = d_lff @ w_lff[:, :, 0, 0, 0]
        d_s, dg = d_r + d_cat[..., :nf], d_cat[..., nf:]
        dus = [None] * len(convs)
        for k in range(len(convs) - 1, -1, -1):
            g_k = growths[j][..., k * gc:(k + 1) * gc]
            dg_k = dg[..., k * gc:(k + 1) * gc]
            d_u = torch.where(g_k >= 0, dg_k, dg_k * slope)
            dus[k] = d_u
            back = F.conv_transpose3d(
                d_u.view(N, X, Y, Z, gc).permute(0, 4, 1, 2, 3), convs[k],
                padding=1).permute(0, 2, 3, 4, 1).reshape(N, X * Y * Z, -1)
            d_s = d_s + back[..., :nf]
            if k:
                dg = torch.cat([dg[..., :gc * k] + back[..., nf:],
                                dg[..., gc * k:]], dim=-1)
        if j % per == 0:
            d_s = d_s + pend
        ds = d_s
        dU.append(torch.cat(dus, dim=-1))
        dLFF.append(d_lff)
    return ds, dU, dLFF


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


def sample(rng, n, lr_xy, hr_xy, zl, C):
    """A seeded LR batch (noise) and a cumulative-sum terrain height Z."""
    import numpy as np

    lr = rng.standard_normal((n, lr_xy, lr_xy, zl, C)).astype(np.float32)
    z = np.cumsum(rng.random((n, hr_xy, hr_xy, zl, 1)), axis=3)
    return lr, (z / z.max()).astype(np.float32)


def trunk_macs(rows, J, nf, gc, K):
    return rows * J * (27 * gc * sum(nf + gc * k for k in range(K))
                       + (nf + gc * K) * nf)


def bound(flops, nbytes, flop_rate):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def check_trunk_kernels(rrdbs, x, d_out, geom, nf, gc, nconv, dev):
    """Phase 3, trunk: forward (both modes), backward and the trainable
    trunk against their plain versions. Returns the bf16 max abs errors
    of the forward and the backward."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import (
        TrainableTrunk,
        trunk_vjp,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    p32 = pack_trunk_weights(rrdbs, torch.float32, dev)
    p16 = pack_trunk_weights(rrdbs, torch.bfloat16, dev)
    log("trunk forward, no residuals (increment trunk(x) - x):")
    got32 = rrdb_trunk(p32, x, **geom)
    want32 = rrdb_trunk_reference(p32, x, **geom)
    check("fp32 kernel vs fp32 plain", rel_l2(got32 - x, want32 - x), 1e-4)
    x16 = x.to(torch.bfloat16)
    xf = x16.float()
    got16 = rrdb_trunk(p16, x16, **geom).float()
    check("bf16 kernel vs fp32 plain",
          rel_l2(got16 - xf, rrdb_trunk_reference(p32, xf, **geom) - xf),
          3e-2)
    same16 = rrdb_trunk_reference(p16, x16, **geom).float()
    max_abs_fwd = (got16 - same16).abs().max().item()
    check("bf16 kernel vs bf16 plain", rel_l2(got16 - xf, same16 - xf), 3e-2)
    log(f"  bf16 max abs {max_abs_fwd:.3e} of max |out| "
        f"{same16.abs().max().item():.3e}")
    del got32, want32, got16, same16

    max_abs_bwd = 0.0
    for name, packed, tol in (("fp32", p32, 1e-4), ("bf16", p16, 3e-2)):
        xin = x.to(packed["lff"].dtype)
        log(f"trunk forward, residual mode, {name}:")
        got = rrdb_trunk(packed, xin, with_residuals=True, **geom)
        want = rrdb_trunk_reference(packed, xin, with_residuals=True, **geom)
        check("out increment", rel_l2(got[0].float() - xin.float(),
                                      want[0].float() - xin.float()), tol)
        check("states", rel_l2(got[1].float(), want[1].float()), tol)
        check("growths", rel_l2(got[2].float(), want[2].float()), tol)
        growths = want[2]
        del got, want
        log(f"trunk backward, {name}:")
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        dout = d_out.to(xin.dtype)
        got = rrdb_trunk_bwd(packed_t, growths, dout, **geom)
        want = rrdb_trunk_bwd_reference(packed_t, growths, dout, **geom)
        for label, g, w in zip(("d_x", "dU", "dLFF"), got, want):
            check(label, rel_l2(g.float(), w.float()), tol)
            if name == "bf16":
                max_abs_bwd = max(max_abs_bwd,
                                  (g.float() - w.float()).abs().max().item())
        del got, want, growths

    log("trainable trunk, fp32, gradients vs autograd of the plain trunk:")
    tgt = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)
                      ).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in p32.items()}
        xv = x.clone().requires_grad_()
        if kernel:
            out = TrainableTrunk.apply(leaves["conv"], leaves["lff"],
                                       leaves["bias"], xv, geom)
        else:
            out = rrdb_trunk_reference(leaves, xv, **geom)
        (out * tgt).sum().backward()
        grads.append([leaves["conv"].grad, leaves["lff"].grad,
                      leaves["bias"].grad, xv.grad])
    labels = ("conv weights", "LFF weights", "LFF bias", "input")
    with torch.no_grad():
        # the Function's backward on the plain forward's residuals: the
        # backward kernel and the dW stage against autograd, same masks
        _, states, growths = rrdb_trunk_reference(p32, x, with_residuals=True,
                                                  **geom)
        vjp = trunk_vjp(p32["conv"], p32["lff"], states, growths, tgt, geom)
        for label, g, w in zip(labels, vjp, grads[1]):
            check(f"backward on the plain residuals, {label}", rel_l2(g, w),
                  1e-4)
        # end to end the two forwards differ in the last bit, and a growth
        # pre-activation that close to 0 takes the other LeakyReLU slope
        _, _, g_kernel = rrdb_trunk(p32, x, with_residuals=True, **geom)
        flips = ((g_kernel >= 0) != (growths >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {growths.numel()}")
        del states, growths, g_kernel
    for label, g, w in zip(labels, *grads):
        check(f"end to end, {label}", rel_l2(g, w), TRAINABLE_TOL)
    return max_abs_fwd, max_abs_bwd


def stencil_inputs(dev, n=32, xy=64, zl=10):
    """Training-shape field, cotangent, 150 m grid and a terrain-following
    Z: a smooth terrain plus positive per-column increments."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2001)
    uvw = rng.standard_normal((n, xy, xy, zl, 3)).astype(np.float32)
    g9 = rng.standard_normal((n, xy, xy, zl, 9)).astype(np.float32)
    coords = np.arange(xy, dtype=np.float32) * 150.0
    xx = np.linspace(0, 2 * np.pi, xy)
    terrain = 200.0 * np.add.outer(np.sin(xx), np.cos(0.5 * xx))
    z = (terrain[None, :, :, None, None]
         + np.cumsum(10.0 + 20.0 * rng.random((n, xy, xy, zl, 1)), axis=3))
    return [torch.from_numpy(a).to(dev) for a in
            (uvw, coords, coords, z.astype(np.float32), g9)]


def check_stencil_kernels(dev):
    """Phase 3, stencil: kernels 3 and 4 against their plain versions and
    the adjoint identity. Returns the max abs errors."""
    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

    uvw, x, y, Z, g9 = stencil_inputs(dev)
    log(f"gradient stencil and adjoint at {tuple(uvw.shape)}:")
    got = stencil.wind_gradient(uvw, x, y, Z)
    want = wind_field_gradient(uvw, x, y, Z)
    check("gradient kernel vs plain", rel_l2(got, want), 1e-5)
    err_g = (got - want).abs().max().item()
    adj = stencil.wind_gradient_adjoint(g9, x, y, Z)
    want_a = stencil.wind_gradient_adjoint_reference(g9, x, y, Z)
    check("adjoint kernel vs plain", rel_l2(adj, want_a), 1e-5)
    err_a = (adj - want_a).abs().max().item()
    lhs = (got.double() * g9.double()).sum().item()
    rhs = (uvw.double() * adj.double()).sum().item()
    ident = abs(lhs - rhs) / abs(lhs)
    log(f"  adjoint identity <Lu, g> = {lhs:.6e}, <u, L^T g> = {rhs:.6e}, "
        f"rel {ident:.3e} (tol 1e-05)")
    if not ident <= 1e-5:
        fail(f"adjoint identity off by {ident:.3e}")
    return err_g, err_a


def time_stencils(dev, card):
    """Kernels 3 and 4 at the training shape: the CUDA-event time of 5
    back-to-back calls through the wrapper (host and card together), the
    card's own time per launch under torch.profiler with the L2 warm
    (back to back) and cold (a scratch buffer of FLUSH_BYTES read before
    each launch, so that the L2 holds none of its inputs and no dirty
    lines), the plain version's time and the bound. Returns
    {"gradient" | "adjoint": dict of ms, device_ms, device_ms_cold,
    plain_ms and bound}."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

    uvw, cx, cy, Z, g9 = stencil_inputs(dev)
    vox = uvw.numel() // 3
    scratch = torch.ones(FLUSH_BYTES // 4, device=dev)
    # per voxel and component: 3 axes x (3 mul + 2 add); z coefficients
    # ~16 operations per voxel; float32 on the CUDA cores. Bytes: the field,
    # the heights and the output once each.
    pairs = {
        "gradient": (lambda: stencil.wind_gradient(uvw, cx, cy, Z),
                     lambda: wind_field_gradient(uvw, cx, cy, Z),
                     bound(vox * (3 * 15 + 16), vox * (12 + 4 + 36),
                           H100_FP32_FLOPS)),
        "adjoint": (lambda: stencil.wind_gradient_adjoint(g9, cx, cy, Z),
                    lambda: stencil.wind_gradient_adjoint_reference(
                        g9, cx, cy, Z),
                    bound(vox * (3 * 17 + 3 * 16), vox * (36 + 4 + 12),
                          H100_FP32_FLOPS)),
    }
    out = {}
    log(f"stencil kernels at {tuple(uvw.shape[:4])}: event time of 5 calls "
        f"through the wrapper, the card's time per launch (profiler) with "
        f"the L2 warm and cold, the plain version ({card}):")
    for label, (fn, plain, b) in pairs.items():
        kernel = STENCIL_KERNELS[label]
        ms = cuda_ms(fn)
        warm = device_ms(fn, kernel)
        cold = device_ms(fn, kernel, flush=scratch.sum)
        plain_ms = cuda_ms(plain)
        log(f"  {label} ({kernel}): event {ms:.4f} ms, card warm "
            f"{warm:.4f} ms, cold {cold:.4f} ms; plain {plain_ms:.3f} ms; "
            f"bound {b[0]:.4f} ms by {b[1]}: "
            + " / ".join(f"{100 * b[0] / t:.1f}" for t in (ms, warm, cold))
            + " % of it (event / warm / cold)")
        if not all(math.isfinite(v) for v in (ms, warm, cold, plain_ms)):
            fail("a stencil timing is not finite")
        out[label] = dict(ms=ms, device_ms=warm, device_ms_cold=cold,
                          plain_ms=plain_ms, bound=b)
    # the yardstick of a bytes-bound kernel on this card: a device-to-device
    # copy that moves the same bytes (half read, half written)
    src = torch.empty(vox * 52 // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy = device_ms(lambda: dst.copy_(src), "Memcpy")
    log(f"  copy of the same {2 * src.numel() / 1e6:.1f} MB, card warm "
        f"{copy:.4f} ms ({100 * pairs['gradient'][2][0] / copy:.1f} % of "
        f"the bound)")
    del scratch, src, dst
    return out


def stencils_of(root):
    """``--stencils-of ROOT``: build and check kernels 3 and 4 of the port
    under ROOT against their plain versions, then time them as phase 6
    does. Two checkouts are compared by running this once for each, in
    turns, within one run on one card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a card")
    sys.path.insert(0, os.path.abspath(root))
    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    card = card_line()
    log(f"stencil kernels of {os.path.abspath(root)}")
    for name, (path, secs, report) in build.build(["stencil"]).items():
        log(f"built {name} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    check_stencil_kernels(dev)
    time_stencils(dev, card)


def head_inputs(dev, n, xy, zl, nf, tc, C, k, seed, weights=None):
    """Head inputs at full width: x, t, a dropout scale with about 10 % of
    the channels zeroed, and (unless given) weights at init scale 1.0."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if weights is None:
        weights = [torch.randn(C, c, k, k, k, generator=gen)
                   * math.sqrt(2.0 / (c * k ** 3)) for c in (nf, tc)]
    x = torch.randn(n, xy, xy, zl, nf, generator=gen)
    t = torch.randn(n, xy, xy, zl, tc, generator=gen)
    dm = torch.where(torch.rand(n, C, generator=gen) < 0.9, 1 / 0.9, 0.0)
    return [w.to(dev) for w in weights] + [v.to(dev) for v in (x, t, dm)]


def plain_head(wx, wt, x, t, dm, k, slope=0.2):
    """Autograd's head: the two convs, LeakyReLU and the scale."""
    import torch.nn.functional as F

    hp = (k - 1) // 2
    pre = (F.conv3d(x.permute(0, 4, 1, 2, 3), wx, padding=hp)
           + F.conv3d(t.permute(0, 4, 1, 2, 3), wt, padding=hp))
    return (F.leaky_relu(pre, slope).permute(0, 2, 3, 4, 1)
            * dm[:, None, None, None, :])


def check_head_kernel(dev, xy, zl, nf, tc, C, k):
    """Phase 3, kernel 5: the HR-head kernel against its plain version at
    full width, batch 2, float32 and bf16, and HRHead's four gradients
    against autograd of the plain head. Returns the bf16 max abs error."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head,
        hr_head_conv,
        hr_head_conv_reference,
        hr_head_vjp,
        pack_head_weights,
    )

    wx, wt, x, t, dm = head_inputs(dev, 2, xy, zl, nf, tc, C, k, 2003)
    log(f"HR head at {tuple(x.shape)} + {tuple(t.shape)} -> C={C}, k={k}, "
        f"{(dm == 0).sum().item()} of {dm.numel()} channels dropped:")
    max_abs = 0.0
    for name, dt, tol in (("fp32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 1e-2)):
        packed = pack_head_weights(wx, wt, dt, dev)
        args = (packed, x.to(dt), t.to(dt), dm.to(dt))
        got = hr_head_conv(*args, k=k, negative_slope=0.2)
        want = hr_head_conv_reference(*args, k=k, negative_slope=0.2)
        check(f"{name} kernel vs {name} plain", rel_l2(got.float(),
                                                      want.float()), tol)
        if dt == torch.bfloat16:
            max_abs = (got.float() - want.float()).abs().max().item()
            log(f"  bf16 max abs {max_abs:.3e} of max |h| "
                f"{want.float().abs().max().item():.3e}")
        del got, want, args
    cot = torch.randn(x.shape[:4] + (C,), generator=torch.Generator()
                      .manual_seed(6)).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = [v.clone().requires_grad_() for v in (wx, wt, x, t)]
        h = (hr_head(*leaves, dm, k=k, negative_slope=0.2) if kernel
             else plain_head(*leaves, dm, k))
        (h * cot).sum().backward()
        grads.append([v.grad for v in leaves])
        if kernel:
            h_kernel = h.detach()
    labels = ("dWx", "dWt", "dx", "dt")
    with torch.no_grad():
        # HRHead's backward on the plain forward's output: the same
        # LeakyReLU sides as autograd's, so only the sums' order differs
        h_plain = plain_head(wx, wt, x, t, dm, k)
        vjp = hr_head_vjp(wx, wt, x, t, dm, h_plain, cot, k=k,
                          negative_slope=0.2)
        for label, g, w in zip(labels, vjp, grads[1]):
            check(f"HRHead backward on the plain output, {label} (fp32)",
                  rel_l2(g, w), 1e-4)
        # end to end, a pre-activation within float32 rounding of 0 can
        # take the other LeakyReLU slope in the kernel than in cuDNN
        flips = ((h_kernel >= 0) != (h_plain >= 0)).sum().item()
        log(f"  head outputs on the other side of 0, kernel vs plain "
            f"forward: {flips} of {h_plain.numel()}")
    for label, g, w in zip(labels, *grads):
        check(f"HRHead end to end, {label} vs autograd (fp32)", rel_l2(g, w),
              HEAD_GRAD_TOL)
    return max_abs


def check_head_bf16(dev, wx, wt, x, t, dm, k, label):
    """The bf16 HR-head kernel against its bf16 plain version on x, t and
    the dropout scale dm (<= 1e-2: one rounding on each side)."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        hr_head_conv_reference,
        pack_head_weights,
    )

    bf = torch.bfloat16
    args = (pack_head_weights(wx, wt, bf, dev), x.to(bf), t.to(bf),
            dm.to(bf))
    with torch.no_grad():
        got = hr_head_conv(*args, k=k, negative_slope=0.2)
        want = hr_head_conv_reference(*args, k=k, negative_slope=0.2)
    check(f"HR head at {label} {tuple(x.shape)}, bf16 kernel vs bf16 plain",
          rel_l2(got.float(), want.float()), 1e-2)


def drive_steps(gan, state, batch, g_want, d_want, card, label):
    """From it = 47 four train_steps (48, 49 G; 50, 51 D) and one
    val_step, with the counts set to 0 just before: finite losses and
    metrics, G and its EMA move on G steps only, D and its batch
    statistics on D steps only, and each kernel's launch count rises by
    what one step predicts. Returns the counts after the val step."""
    import torch

    state.it = 47
    reset_counters()
    for _ in range(4):
        lr, hr, z = batch()
        it = state.it + 1
        g_step = gan.is_g_step(it)
        snap = {name: {k: v.clone() for k, v in tree.items()} for name, tree
                in (("G", state.params_G), ("EMA", state.params_G_ema),
                    ("D", state.params_D), ("BN", state.batch_stats_D))}
        before = counters()
        t = time.monotonic()
        state, metrics = gan.train_step(state, lr, hr, z)
        torch.cuda.synchronize()
        secs = time.monotonic() - t
        rose = tuple(a - b for a, b in zip(counters(), before))
        kind = "G" if g_step else "D"
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"  it {it} ({kind} step, {secs:.2f} s): "
            + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items()))
            + f"; launches {LAUNCH_LABELS} {rose}")
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"non-finite metric at it {it}")
        want = g_want if g_step else d_want
        if rose != want:
            fail(f"{kind} step launched {rose}, expected {want}")
        for name, tree in (("G", state.params_G), ("EMA", state.params_G_ema),
                           ("D", state.params_D), ("BN", state.batch_stats_D)):
            moved = any(not torch.equal(v, snap[name][k])
                        for k, v in tree.items())
            should = g_step == (name in ("G", "EMA"))
            if moved != should:
                fail(f"{name} {'moved' if moved else 'stood still'} on the "
                     f"{kind} step at it {it}")
    lr, hr, z = batch()
    metrics, _ = gan.val_step(state, lr, hr, z)
    vals = {k: float(v) for k, v in metrics.items()}
    log("  val: " + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items())))
    if not all(math.isfinite(v) for v in vals.values()):
        fail("non-finite validation metric")
    total = counters()
    log(f"  {label} launches (4 steps + val) {LAUNCH_LABELS} {total} ({card})")
    return total


def plain_trunk_cotangents(packed, x, d_out, geom):
    """Autograd through the trunk's plain version (the arithmetic of
    rrdb_trunk_reference, with the same rounding points) on x with the
    cotangent d_out. Returns d_x, the growth convs' pre-activation
    cotangents dU and the LFF outputs' cotangents dLFF (J-major, as the
    backward kernel writes them) and the packed weight gradients."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import _conv_kernels

    gc, K = geom["gc"], geom["num_convs"] - 1
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in packed.items()}
    J, nf = leaves["lff"].shape[0], x.shape[-1]
    dt = x.dtype
    s1 = torch.tensor(geom["rdb_scale"], dtype=dt, device=x.device)
    s2 = torch.tensor(geom["rrdb_scale"], dtype=dt, device=x.device)
    kernels = _conv_kernels(leaves["conv"], J, nf, gc, K)
    xv = x.detach().clone().requires_grad_()
    state = xv.permute(0, 4, 1, 2, 3)
    rres = state
    pres, lffs = [], []
    for j in range(J):
        if j % 3 == 0:
            rres = state
        feats = state.float()
        for w in kernels[j]:
            pre = F.conv3d(feats, w.float(), padding=1)
            pre.retain_grad()
            pres.append(pre)
            y = F.leaky_relu(pre, geom["negative_slope"])
            feats = torch.cat([feats, y.to(dt).float()], dim=1)
        w_lff = leaves["lff"][j].t().float()[:, :, None, None, None]
        lff = F.conv3d(feats, w_lff, bias=leaves["bias"][j].float()).to(dt)
        lff.retain_grad()
        lffs.append(lff)
        new = state + lff * s1
        if j % 3 == 2:
            new = rres + new * s2
        state = new
    state.permute(0, 2, 3, 4, 1).backward(d_out)

    def stream(ts):  # per-RDB NCDHW -> J-major (J, N, R, C)
        t = torch.stack(ts).permute(0, 1, 3, 4, 5, 2)
        return t.reshape(J, x.shape[0], -1, t.shape[-1])

    dU = stream([torch.cat([p.grad for p in pres[j * K:(j + 1) * K]], dim=1)
                 for j in range(J)])
    dLFF = stream([v.grad for v in lffs])
    return (xv.grad, dU, dLFF,
            (leaves["conv"].grad, leaves["lff"].grad, leaves["bias"].grad))


def split_g_gap(packed, x, d_out, geom, nf, gc, nconv):
    """The G-gradient gap, kernels vs autograd of the trunk's plain
    version, stage by stage on the trunk input x and output cotangent
    d_out captured in the kernels' G step, bf16: (a) the residual mode
    against the plain forward, (b) the backward kernel against autograd on
    the plain residuals, (c) the dW stage against autograd's weight
    gradients."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import (
        _dw_stage,
        trunk_vjp,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    shape = tuple(x.shape[:4])
    K = nconv - 1
    log(f"G-gradient gap by stage, bf16, on the G step's trunk input "
        f"{tuple(x.shape)} and output cotangent (|d_out| "
        f"{torch.linalg.vector_norm(d_out.double()).item():.3e}):")
    with torch.no_grad():
        got = rrdb_trunk(packed, x, with_residuals=True, **geom)
        want = rrdb_trunk_reference(packed, x, with_residuals=True, **geom)
        for label, a, b in zip(("out", "states", "growths"), got, want):
            log(f"  (a) residual mode vs plain forward, {label}: rel L2 "
                f"{rel_l2(a.float(), b.float()):.3e}")
        k_states, k_growths = got[1], got[2]
        _, states, growths = want
        del got, want
    d_x_a, dU_a, dLFF_a, dW_a = plain_trunk_cotangents(packed, x, d_out,
                                                       geom)
    with torch.no_grad():
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        k_bwd = rrdb_trunk_bwd(packed_t, growths, d_out, **geom)
        p_bwd = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **geom)
        for label, kb, pb, a in zip(("d_x", "dU", "dLFF"), k_bwd, p_bwd,
                                    (d_x_a, dU_a, dLFF_a)):
            log(f"  (b) on the plain residuals, {label}: kernel vs autograd "
                f"{rel_l2(kb.float(), a.float()):.3e}, plain version vs "
                f"autograd {rel_l2(pb.float(), a.float()):.3e}, kernel vs "
                f"plain version {rel_l2(kb.float(), pb.float()):.3e}")
        # where the backward starts to part from autograd: RDB by RDB from
        # the last (the first the backward runs) to the first
        J = dLFF_a.shape[0]
        for j in sorted({max(j, 0) for j in (J - 1, J - 2, J - 3, J - 4,
                                             J // 2, 0)}, reverse=True):
            log(f"  (b) RDB {j}, plain version vs autograd: dLFF "
                f"{rel_l2(p_bwd[2][j].float(), dLFF_a[j].float()):.3e}, dU "
                f"{rel_l2(p_bwd[1][j].float(), dU_a[j].float()):.3e}")
        labels = ("conv weights", "LFF weights", "LFF bias")
        dw_k = _dw_stage(states, growths, k_bwd[1], k_bwd[2], shape, nf, gc,
                         K)
        dw_a = _dw_stage(states, growths, dU_a.to(x.dtype), dLFF_a, shape,
                         nf, gc, K)
        for label, wk, wa, a in zip(labels, dw_k, dw_a, dW_a):
            log(f"  (c) dW stage vs autograd, {label}: on the kernel's "
                f"cotangents {rel_l2(wk.float(), a.float()):.3e}, on "
                f"autograd's cotangents rounded to bf16 "
                f"{rel_l2(wa.float(), a.float()):.3e}")
        vjp = trunk_vjp(packed["conv"], packed["lff"], k_states, k_growths,
                        d_out, geom)
        for label, g, a in zip(labels + ("input",), vjp, dW_a + (d_x_a,)):
            log(f"  the G step's trunk VJP (kernel residuals) vs autograd, "
                f"{label}: {rel_l2(g.float(), a.float()):.3e}")


def train_phase(cfg, dev, rng, card):
    """Phase 5: the milestone9k WindFieldGAN at batch 32 on the card.
    Returns what phase 6 times."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.models import fused_train
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
        trunk_geometry,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        rrdb_trunk_reference,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    n = cfg.dataset_train.batch_size
    size, s = cfg.gan_config.slice_size, cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    C = cfg.lr_num_channels
    coords = np.arange(size, dtype=np.float32) * 150.0
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    if not gan.use_fused_trunk:
        fail("milestone9k does not take the trunk kernels in training")
    lr_shape = (n, size // s, size // s, zl, C)
    hr_shape = (n, size, size, zl, 3)
    state = gan.init_state(2001, lr_shape, hr_shape)

    def batch():
        lr, z = sample(rng, n, size // s, size, zl, C)
        hr = 0.1 * rng.standard_normal(hr_shape).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (lr, hr, z)]

    log(f"train: milestone9k WindFieldGAN, batch {n}, LR {lr_shape}, "
        f"HR {hr_shape}, bf16")
    # one G step's gradients, kernels vs the plain trunk and stencil, on the
    # same weights, batch, dropout mask and noise draws
    lr, hr, z = batch()
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.use_fused_trunk = False
    plain_cfg.use_pallas_stencil = False
    plain = WindFieldGAN(plain_cfg, coords, coords, device=dev)
    plain.D = gan.D  # the same D module; its parameters come from the state
    gen = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[1]),
                      generator=gen, device=dev) < 0.9
    res = []
    # the kernels' step keeps the trunk's input and output cotangent, on
    # which the gap is split stage by stage below
    captured = {}
    real_vjp = fused_train.trunk_vjp

    def capture_vjp(conv, lff, states, growths, d_out, geom):
        captured.update(x=states[0].reshape(d_out.shape).clone(),
                        d_out=d_out.detach().to(conv.dtype).clone())
        return real_vjp(conv, lff, states, growths, d_out, geom)

    for g in (gan, plain):
        gen = torch.Generator(device=dev).manual_seed(12)
        fused_train.trunk_vjp = capture_vjp if g is gan else real_vjp
        try:
            res.append(g.g_grads(state, lr, hr, z, 48, gen,
                                 dropout_mask=keep))
        finally:
            fused_train.trunk_vjp = real_vjp
        torch.cuda.synchronize()
    # the plain path once more with autograd through the trunk's plain
    # version instead of the RRDB modules: it rounds where the kernels do,
    # so it splits the gap into the kernels' part and the module path's
    G_ref = plain.G

    def ref_trunk(x):
        packed = pack_trunk_weights(G_ref.rrdbs, G_ref.dtype, x.device,
                                    detach=False)
        return rrdb_trunk_reference(packed, x.contiguous(),
                                    **trunk_geometry(G_ref))

    def ref_forward(lr, z, train=False, trunk=None, head=None,
                    dropout_mask=None, generator=None):
        return generator_forward(G_ref, lr, z, ref_trunk, train=train,
                                 dropout_mask=dropout_mask,
                                 generator=generator)

    G_ref.forward = ref_forward
    gen = torch.Generator(device=dev).manual_seed(12)
    res.append(plain.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
    torch.cuda.synchronize()
    (loss_k, _, grads_k), (loss_p, _, grads_p), (loss_r, _, grads_r) = res
    log(f"  G step total loss: kernels {loss_k.item():.6e}, plain "
        f"{loss_p.item():.6e}, plain trunk version {loss_r.item():.6e}")
    worst = max((rel_l2(a, b), name) for a, b, name in
                zip(grads_k, grads_p, state.params_G))

    def flat(gs):
        return torch.cat([g.flatten() for g in gs])

    err = rel_l2(flat(grads_k), flat(grads_p))
    log(f"  worst single tensor: {worst[1]} rel L2 {worst[0]:.3e}")
    log(f"  G gradients, kernels vs autograd of the trunk's plain version: "
        f"rel L2 {rel_l2(flat(grads_k), flat(grads_r)):.3e}; that vs the "
        f"module path: {rel_l2(flat(grads_r), flat(grads_p)):.3e}")
    names = list(state.params_G)
    for group, pick in (("trunk (rrdbs.*)", True), ("the rest", False)):
        idx = [i for i, k in enumerate(names)
               if k.startswith("rrdbs.") == pick]
        sub = [(grads_k[i], grads_r[i]) for i in idx]
        share = (torch.linalg.vector_norm(flat([b for _, b in sub]).double())
                 / torch.linalg.vector_norm(flat(grads_r).double())).item()
        log(f"    {group}: kernels vs plain trunk version rel L2 "
            f"{rel_l2(flat([a for a, _ in sub]), flat([b for _, b in sub])):.3e}"
            f", {share:.3f} of the gradient's norm")
    check("G gradients, kernels vs plain path (bf16)", err, G_GRAD_TOL)
    del plain, res, grads_k, grads_p, grads_r, G_ref
    G = gan.G
    G.load_state_dict(state.params_G)
    with torch.no_grad():
        packed = pack_trunk_weights(G.rrdbs, G.dtype, dev)
    g = cfg.generator
    split_g_gap(packed, captured["x"], captured["d_out"], trunk_geometry(G),
                g.num_features, g.RDB_growth_chan, g.num_RDB_convs)
    del packed, captured
    torch.cuda.empty_cache()

    total = drive_steps(gan, state, batch, G_STEP_LAUNCHES, D_STEP_LAUNCHES,
                        card, "train path")
    return gan, state, batch, total


def head_train_phase(cfg, gan, state, batch, dev, card):
    """Phase 5, head path: a copy of milestone9k with use_pallas_head at
    batch 32. One G step's gradients with the head kernel against the
    same step with the module head (trunk kernels on both sides), then
    two G and two D steps and a val step through the head kernel.
    Returns the head-path gan, its state and its launch counts."""
    import torch

    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    hcfg = copy.deepcopy(cfg)
    hcfg.use_pallas_head = True
    gan_h = WindFieldGAN(hcfg, gan.x.cpu().numpy(), gan.y.cpu().numpy(),
                         device=dev)
    if (gan_h._head_train, gan_h._head_nograd) != ("kernel", "kernel"):
        fail("use_pallas_head does not route milestone9k through the head")
    n = cfg.dataset_train.batch_size
    log(f"train, head path: milestone9k with use_pallas_head, batch {n}, "
        f"bf16")
    gan_h.D = gan.D  # the same D module; its parameters come from the state
    lr, hr, z = batch()
    gen = torch.Generator(device=dev).manual_seed(13)
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[1]),
                      generator=gen, device=dev) < 0.9
    res = []
    for g in (gan_h, gan):
        gen = torch.Generator(device=dev).manual_seed(14)
        res.append(g.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
        torch.cuda.synchronize()
    (loss_h, _, grads_h), (loss_m, _, grads_m) = res
    flat_h = torch.cat([g.flatten() for g in grads_h])
    flat_m = torch.cat([g.flatten() for g in grads_m])
    worst = max((rel_l2(a, b), name) for a, b, name in
                zip(grads_h, grads_m, state.params_G))
    log(f"  G step total loss: head kernel {loss_h.item():.6e}, module head "
        f"{loss_m.item():.6e}; worst single tensor {worst[1]} rel L2 "
        f"{worst[0]:.3e}")
    check("G gradients, head kernel vs module head (bf16)",
          rel_l2(flat_h, flat_m), 2e-2)
    del res, grads_h, grads_m, flat_h, flat_m
    state_h = gan_h.init_state(2001, (n,) + tuple(lr.shape[1:]),
                               (n,) + tuple(hr.shape[1:]))
    total = drive_steps(gan_h, state_h, batch, G_STEP_LAUNCHES_HEAD,
                        D_STEP_LAUNCHES_HEAD, card, "head path")
    return gan_h, state_h, total


def time_training(gan, state, batch, geom, nf, gc, nconv, dev, card):
    """Phase 6, training: the trunk kernels against their plain versions
    at batch 32, then G and D steps with their parts, and each training
    kernel beside its plain version, bound and library chain."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import _dw_stage
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    lr, hr, z = batch()

    def step(it):
        def fn():
            state.it = it - 1
            gan.train_step(state, lr, hr, z)
        return fn

    g_ms = cuda_ms(step(48))
    d_ms = cuda_ms(step(50))
    gen_ms = cuda_ms(lambda: gan.generate(state, lr, z))

    # the trunk kernels at the training batch, on the state's weights
    G = gan.G
    G.load_state_dict(state.params_G)
    with torch.no_grad():
        packed = pack_trunk_weights(G.rrdbs, torch.bfloat16, dev)
        lib_w = [([c.weight.to(torch.bfloat16) for c in rdb.convs],
                  rdb.lff.weight.to(torch.bfloat16),
                  rdb.lff.bias.to(torch.bfloat16))
                 for r in G.rrdbs for rdb in r.rdbs]
        # the trunk's input in a G step on this batch
        x = G.feature_conv(lr.to(G.dtype)).contiguous()
    n = lr.shape[0]
    gen = torch.Generator().manual_seed(3)
    d_out = torch.randn(x.shape, generator=gen).to(dev, torch.bfloat16)
    kw = dict(geom)
    with torch.no_grad():
        log(f"trunk kernels at batch {n}, trunk input of a training batch, "
            f"bf16 vs bf16 plain:")
        got = rrdb_trunk(packed, x, with_residuals=True, **kw)
        want = rrdb_trunk_reference(packed, x, with_residuals=True, **kw)
        xf = x.float()
        check("residual mode, out increment",
              rel_l2(got[0].float() - xf, want[0].float() - xf), 3e-2)
        check("residual mode, states",
              rel_l2(got[1].float(), want[1].float()), 3e-2)
        check("residual mode, growths",
              rel_l2(got[2].float(), want[2].float()), 3e-2)
        # a growth on the other side of 0 takes the other LeakyReLU slope
        # in the backward: what sets the G step's bf16 gradient gap
        flips = ((got[2] >= 0) != (want[2] >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {want[2].numel()} ({flips / want[2].numel():.3e})")
        _, states, growths = got
        del got, want
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        got = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **kw)
        for label, a, b in zip(("d_x", "dU", "dLFF"), got, want):
            check(f"backward, {label}", rel_l2(a.float(), b.float()), 3e-2)
        del got, want
        turns1 = alternate(
            lambda: rrdb_trunk(packed, x, with_residuals=True, **kw),
            lambda: cudnn_trunk(lib_w, x, keep=True))
        log_turns(f"trunk residual mode at batch {n} vs its bf16 cuDNN chain",
                  turns1, card)
        k1r_ms, k1r_lib_ms = turns1[:2]
        k1r_plain_ms = cuda_ms(lambda: rrdb_trunk_reference(
            packed, x, with_residuals=True, **kw))
        turns2 = alternate(
            lambda: rrdb_trunk_bwd(packed_t, growths, d_out, **kw),
            lambda: cudnn_trunk_bwd(lib_w, growths, d_out))
        log_turns(f"trunk backward at batch {n} vs its bf16 cuDNN/cuBLAS "
                  f"chain", turns2, card)
        k2_ms, k2_lib_ms = turns2[:2]
        k2_plain_ms = cuda_ms(lambda: rrdb_trunk_bwd_reference(
            packed_t, growths, d_out, **kw))
        kernel_split(f"trunk residual mode at batch {n}, by kernel",
                     lambda: rrdb_trunk(packed, x, with_residuals=True, **kw),
                     card)
        kernel_split(f"trunk backward at batch {n}, by kernel",
                     lambda: rrdb_trunk_bwd(packed_t, growths, d_out, **kw),
                     card)
        _, dU, dLFF = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        dw_ms = cuda_ms(lambda: _dw_stage(states, growths, dU, dLFF,
                                          tuple(x.shape[:4]), nf, gc,
                                          nconv - 1))
        del states, growths, dU, dLFF
        st = time_stencils(dev, card)
    k3, k4 = st["gradient"], st["adjoint"]
    k3_ms, k4_ms = k3["ms"], k4["ms"]

    rows = x.numel() // nf
    J = len(lib_w)
    K = nconv - 1
    flops = 2 * trunk_macs(rows, J, nf, gc, K)
    w_bytes = 2 * sum(t.numel() for t in packed.values())
    res_bytes = 2 * J * rows * (nf + gc * K)
    b1 = bound(flops, 2 * 2 * x.numel() + w_bytes + res_bytes,
               H100_BF16_FLOPS)
    # backward: reads growths and d_out, writes d_x, dU and dLFF, reads
    # the transposed weights once
    b2 = bound(flops, 2 * (J * rows * gc * K + 2 * x.numel()
                           + J * rows * (gc * K + nf)) + w_bytes,
               H100_BF16_FLOPS)
    rest_g = g_ms - k1r_ms - k2_ms - dw_ms - 2 * k3_ms - k4_ms
    log(f"G step {g_ms:.3f} ms, D step {d_ms:.3f} ms, no-grad G forward "
        f"{gen_ms:.3f} ms at batch {n} ({card})")
    for label, ms in (("trunk kernel, residual mode", k1r_ms),
                      ("trunk backward kernel", k2_ms),
                      ("dW stage (cuDNN, cuBLAS)", dw_ms),
                      ("gradient kernel x2", 2 * k3_ms),
                      ("adjoint kernel", k4_ms),
                      ("rest: head/tail convs fwd+bwd, D, losses, Adam",
                       rest_g)):
        log(f"  G step part {label:<48} {ms:9.3f} ms "
            f"{100 * ms / g_ms:5.1f} %")
    parts = g_step_rest_parts(gan, state, lr, hr, z)
    for label, ms in parts:
        log(f"    rest part {label:<46} {ms:9.3f} ms "
            f"{100 * ms / g_ms:5.1f} %")
    gap = rest_g - sum(ms for _, ms in parts)
    log(f"    rest parts sum {rest_g - gap:.3f} ms of the rest's "
        f"{rest_g:.3f} ms; all parts {g_ms - gap:.3f} ms of the G step's "
        f"{g_ms:.3f} ms ({100 * (g_ms - gap) / g_ms:.1f} %)"
        + (f"; the parts miss {gap:.3f} ms" if abs(gap) > 0.1 * g_ms
           else ""))
    log(f"  D step part no-grad G forward {gen_ms:9.3f} ms "
        f"{100 * gen_ms / d_ms:5.1f} %, rest (D fwd+bwd twice, Adam) "
        f"{d_ms - gen_ms:9.3f} ms")
    for label, ms, plain_ms, b, lib in (
            ("trunk residual mode", k1r_ms, k1r_plain_ms, b1, k1r_lib_ms),
            ("trunk backward", k2_ms, k2_plain_ms, b2, k2_lib_ms)):
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib:.3f} ms, bound {b[0]:.4f} ms by {b[1]} (ops "
            f"{b[2]:.4f}, bytes {b[3]:.4f}); {100 * b[0] / ms:.2f} % of the "
            f"bound, {H100_BF16_FLOPS * b[2] / ms / 1e12:.1f} TFLOP/s")
    times = dict(g_ms=g_ms, d_ms=d_ms, k1r=(k1r_ms, k1r_plain_ms, b1),
                 k1r_lib=k1r_lib_ms,
                 k2=(k2_ms, k2_plain_ms, b2, k2_lib_ms), k3=k3, k4=k4)
    if not all(math.isfinite(v) for v in (g_ms, d_ms, gen_ms, k1r_ms, k2_ms,
                                           dw_ms, k3_ms, k4_ms, k2_lib_ms,
                                           k1r_lib_ms)):
        fail("a timing is not finite")
    return times


def g_step_rest_parts(gan, state, lr, hr, z):
    """(name, ms) of the G step's parts outside the trunk and stencil
    kernels, each timed alone (forward and backward, input and weight
    gradients where the G step takes them) on the tensors a G step on
    this batch gives it. G holds state.params_G."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.models.blocks import channel_dropout
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        kernel_trunk_fn,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
    )
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy
    from gan_sr_wind_field_tpu_torch.train.gan import AdamState

    G = gan.G
    dt = G.dtype
    slope = G.negative_slope
    p = G.dropout_probability
    it = 48
    with torch.no_grad():
        f = G.feature_conv(lr.to(dt))
        tr = kernel_trunk_fn(G)(f)
        h0 = f + G.lr_conv(tr)
        h = h0
        for up in G.upconvs:
            h = up(upsample_nearest_xy(h, 2))
        zt = z.to(dt)
        t = G.terrain_conv1(G.terrain_conv0(zt))
        px, pt = G.hr_conv0_x(h), G.hr_conv0_t(t)
        a = F.leaky_relu(px + pt, slope)
        fake = G.hr_conv1(a).float()
        keep = torch.rand((lr.shape[0], 1, 1, 1, a.shape[-1]),
                          device=a.device) < 1.0 - p
        hr3 = hr[..., :3]
        y_pred = gan._d_apply(state.params_D, state.batch_stats_D, hr3,
                              train=False)
        fake_pred = gan._d_apply(state.params_D, state.batch_stats_D, fake,
                                 train=False)
        hr_grad = gan._wind_gradient(hr3, gan.x, gan.y, z)
        sr_grad = gan._wind_gradient(fake, gan.x, gan.y, z)

    def fwd_bwd(fn, modules, *inputs):
        leaves = [v.detach().requires_grad_() for v in inputs]
        params = [q for m in modules for q in m.parameters()]

        def run():
            out = fn(*leaves)
            torch.autograd.grad(out, leaves + params, torch.ones_like(out),
                                allow_unused=True)
        return run

    def ups(x):
        for up in G.upconvs:
            x = up(upsample_nearest_xy(x, 2))
        return x

    def small_convs(lr_, tr_, z_):
        return (G.feature_conv(lr_).float().sum()
                + G.lr_conv(tr_).float().sum()
                + G.terrain_conv1(G.terrain_conv0(z_)).float().sum())

    def packing():
        packed = pack_trunk_weights(G.rrdbs, dt, lr.device, detach=False)
        with torch.no_grad():
            pack_trunk_weights_bwd(packed, nf=G.num_features,
                                   gc=G.rdb_growth_channels,
                                   num_convs=G.num_rdb_convs)
        return torch.cat([v.flatten() for v in packed.values()])

    fake_l = fake.detach().requires_grad_()

    def d_part():
        gan._set_iteration(it)
        real_in = gan._noisy_d_input(hr3, 2.0, state.rng)
        fake_in = gan._noisy_d_input(fake_l, 2.0, state.rng)
        with torch.no_grad():
            gan._d_apply(state.params_D, state.batch_stats_D, real_in,
                         train=False)
        out = gan._d_apply(state.params_D, state.batch_stats_D, fake_in,
                           train=False)
        torch.autograd.grad(out.sum(), fake_l)

    def losses():
        # _g_losses with the G forward, the D forwards and the stencils
        # replaced by their outputs: the loss arithmetic alone
        fy_l = fake_pred.detach().requires_grad_()
        sg_l = sr_grad.detach().requires_grad_()
        preds = iter([y_pred, fy_l])
        saved = gan._wind_gradient
        gan._g_forward_train = lambda *a, **k: fake_l
        gan._d_apply = lambda *a, **k: next(preds)
        gan._wind_gradient = (lambda u, *a: sg_l if u.requires_grad
                              else hr_grad)
        try:
            total, _ = gan._g_losses(state.params_G, state, lr, hr, z, it,
                                     state.rng, True)
        finally:
            del gan._g_forward_train, gan._d_apply
            gan._wind_gradient = saved
        torch.autograd.grad(total, [fake_l, fy_l, sg_l], allow_unused=True)

    params = {k: v.clone() for k, v in state.params_G.items()}
    grads = [torch.randn_like(v) * 1e-4 for v in params.values()]
    opt = AdamState(torch.ones((), dtype=torch.int32, device=lr.device),
                    {k: torch.zeros_like(v) for k, v in params.items()},
                    {k: torch.zeros_like(v) for k, v in params.items()})
    ema = {k: v.clone() for k, v in params.items()}

    def adam_ema():
        gan._adam_step(params, grads, opt, 1e-4, *gan.opt_G)
        with torch.no_grad():
            for k, e in ema.items():
                e.add_(0.01 * (params[k] - e))

    parts = [
        ("hr_conv0_x fwd+bwd", fwd_bwd(G.hr_conv0_x, [G.hr_conv0_x], h)),
        ("hr_conv0_t fwd+bwd", fwd_bwd(G.hr_conv0_t, [G.hr_conv0_t], t)),
        ("hr_conv0 sum, LeakyReLU, dropout fwd+bwd", fwd_bwd(
            lambda u, v: channel_dropout(F.leaky_relu(u + v, slope), p,
                                         keep), [], px, pt)),
        ("hr_conv1 fwd+bwd", fwd_bwd(lambda v: G.hr_conv1(v).float(),
                                     [G.hr_conv1], a)),
        ("upsampling convs fwd+bwd", fwd_bwd(ups, G.upconvs, h0)),
        ("feature, lr_conv, terrain convs fwd+bwd", fwd_bwd(
            small_convs, [G.feature_conv, G.lr_conv, G.terrain_conv0,
                          G.terrain_conv1], lr.to(dt), tr, zt)),
        ("trunk weight packing fwd+bwd", fwd_bwd(packing, G.rrdbs)),
        ("D eval forwards x2, input gradient", d_part),
        ("losses fwd+bwd (no stencils)", losses),
        ("Adam and EMA", adam_ema),
    ]
    return [(name, cuda_ms(fn)) for name, fn in parts]


def library_head(wx, wt, x, t, dm, k, slope=0.2):
    """The head as bf16 cuDNN calls: both convs, their sum, LeakyReLU and
    the scale (the library yardstick for kernel 5's `library_ms`; the port
    never calls this)."""
    import torch.nn.functional as F

    hp = (k - 1) // 2
    pre = (F.conv3d(x.permute(0, 4, 1, 2, 3), wx, padding=hp)
           + F.conv3d(t.permute(0, 4, 1, 2, 3), wt, padding=hp))
    return F.leaky_relu(pre, slope) * dm[:, :, None, None, None]


def head_training_input(gan_h, state_h, batch):
    """The head's x and t in the head path's G forward on a training batch
    (the arguments of the HR-head kernel's launch, caught on their way)."""
    from gan_sr_wind_field_tpu_torch.ops import hr_head as head_mod

    caught = []
    launch = head_mod.hr_head_conv

    def catch(packed, x, t, dmask=None, **kw):
        caught.append((x, t))
        return launch(packed, x, t, dmask, **kw)

    lr, _, z = batch()
    head_mod.hr_head_conv = catch
    try:
        gan_h.generate(state_h, lr, z)
    finally:
        head_mod.hr_head_conv = launch
    return caught[0]


def time_head(sr, sr_h, gan_h, state_h, batch, lr_d, z_d, dims, dev, card):
    """Phase 6, kernel 5: at batch 32 on the head's input of a training
    batch, the bf16 kernel against its bf16 plain version; its time at
    batch 8 and 32 beside its plain version, bound and library call (bf16
    cuDNN, timed with cudnn.benchmark off and on), and the time of its
    cuDNN backward (hr_head_vjp) at batch 32; then the head path's serving
    forward at batch 8 and its G and D steps at batch 32."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        hr_head_conv_reference,
        hr_head_vjp,
        pack_head_weights,
    )

    xy, zl, nf, tc, C, k = dims
    x, t = head_training_input(gan_h, state_h, batch)
    Gh = gan_h.G
    Gh.load_state_dict(state_h.params_G)
    gen = torch.Generator().manual_seed(2006)
    dm = torch.where(torch.rand(x.shape[0], C, generator=gen) < 0.9,
                     1 / 0.9, 0.0).to(dev)
    check_head_bf16(dev, Gh.hr_conv0_x.weight.detach(),
                    Gh.hr_conv0_t.weight.detach(), x, t, dm, k,
                    "the head input of a training batch,")
    del x, t, dm
    G = sr.G
    w = [G.hr_conv0_x.weight.detach(), G.hr_conv0_t.weight.detach()]
    packed = pack_head_weights(*w, torch.bfloat16, dev)
    wb = [v.to(torch.bfloat16) for v in w]
    res = {}
    for n in (8, 32):
        _, _, x, t, dm = head_inputs(dev, n, xy, zl, nf, tc, C, k, 2004 + n,
                                     weights=w)
        x, t, dm = (v.to(torch.bfloat16) for v in (x, t, dm))
        kw = dict(k=k, negative_slope=0.2)
        lib = {}
        with torch.no_grad():
            ms = cuda_ms(lambda: hr_head_conv(packed, x, t, dm, **kw))
            plain_ms = cuda_ms(lambda: hr_head_conv_reference(packed, x, t,
                                                              dm, **kw))
            benchmark = torch.backends.cudnn.benchmark
            for mode in (False, True):
                torch.backends.cudnn.benchmark = mode
                try:
                    lib[mode] = cuda_ms(lambda: library_head(*wb, x, t, dm,
                                                             k))
                finally:
                    torch.backends.cudnn.benchmark = benchmark
        lib_ms = min(lib.values())
        rows = x.numel() // nf
        b = bound(2 * k ** 3 * (nf + tc) * C * rows,
                  2 * (x.numel() + t.numel() + rows * C + packed.numel()
                       + dm.numel()), H100_BF16_FLOPS)
        log(f"HR-head kernel at batch {n}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, cuDNN bf16 {lib[False]:.3f} ms "
            f"(cudnn.benchmark off), {lib[True]:.3f} ms (on); kernel "
            f"{'faster' if ms < lib_ms else 'slower'} than the faster by "
            f"{max(ms, lib_ms) / min(ms, lib_ms):.2f}x; bound "
            f"{b[0]:.4f} ms by {b[1]} (ops {b[2]:.4f}, bytes {b[3]:.4f}), "
            f"{100 * b[0] / ms:.2f} % of it; "
            f"{2 * k ** 3 * (nf + tc) * C * rows / ms / 1e9:.3f} TFLOP/s "
            f"({card})")
        res[n] = (ms, plain_ms, b, lib_ms, lib[False], lib[True])
        if n == 32:
            # the head's backward (cuDNN transposed convs), as a G step on
            # the head path runs it: all four gradients from the saved h
            h = hr_head_conv(packed, x, t, dm, **kw)
            dh = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16)
            with torch.no_grad():
                res["vjp"] = cuda_ms(lambda: hr_head_vjp(
                    *wb, x, t, dm, h, dh, k=k, negative_slope=0.2))
            log(f"  head part hr_head_vjp (cuDNN backward: dWx, dWt, dx, dt) "
                f"at batch {n}: {res['vjp']:.3f} ms ({card})")
            del h, dh
        del x, t, dm
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: sr_h._generate(lr_d, z_d))
    lr, hr, z = batch()

    def step(it):
        def fn():
            state_h.it = it - 1
            gan_h.train_step(state_h, lr, hr, z)
        return fn

    g_ms, d_ms = cuda_ms(step(48)), cuda_ms(step(50))
    vox = lr_d.shape[0] * xy * xy * zl
    log(f"head path: serving forward {fwd_ms:.3f} ms per batch of 8, "
        f"{vox / (fwd_ms / 1e3):.4e} HR voxels/s; G step {g_ms:.3f} ms, D "
        f"step {d_ms:.3f} ms at batch {lr.shape[0]} ({card})")
    if not all(math.isfinite(v) for v in (fwd_ms, g_ms, d_ms, *res[8][:2],
                                          *res[32][:2], *res[8][3:],
                                          *res[32][3:], res["vjp"])):
        fail("a timing is not finite")
    return res


# phase 7: the leg of milestone9k the loop trains (it 6000 -> 6016 from the
# 6k pack), its schedule cut so that 16 steps cross two G and two D blocks,
# two validations and two checkpoints
LEG_FROM, LEG_TO = 6000, 6016
LEG_SCHEDULE = dict(log_period=4, val_period=8, save_model_period=8,
                    keep_checkpoints=2, d_g_train_period=4)
LEG_DATA = ("--synthetic_hours", "240", "--synthetic_size", "128")
VAL_LAUNCHES = (1, 0, 2, 0, 0)       # one validation batch (val_step)
GENERATE_LAUNCHES = (1, 0, 0, 0, 0)  # one generate call (the image dump)
# a resumed leg's trees against the uninterrupted leg's, where the card's
# step is not deterministic (PERF.md section 6)
RESUME_TOL = 1e-3


class Patches:
    """Wrappers set on classes and modules for a while: ``patch(owner,
    name, wrapper)`` replaces ``owner.name`` by ``wrapper(real)``;
    ``close()`` puts every one back."""

    def __init__(self):
        self._undo = []

    def patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        setattr(owner, name, wrapper(real))
        self._undo.append((owner, name, real))

    def close(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


class LegProbe(Patches):
    """Counts and times what the loop calls during a leg, from the outside:
    a CUDA event at the start of each train_step (with its it), each
    val_step and generate call, and each validation sweep and checkpoint
    save, synchronized and timed."""

    def __init__(self):
        import torch

        from gan_sr_wind_field_tpu_torch.train import checkpoint, loop
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        super().__init__()
        self.steps, self.calls = [], {"val_step": 0, "generate": 0}
        self.val_s, self.saves = [], []
        probe = self
        patch = self.patch

        def on_step(real):
            def step(gan, state, *a, **kw):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                probe.steps.append((state.it + 1, gan.is_g_step(state.it + 1),
                                    ev, state.it))
                return real(gan, state, *a, **kw)
            return step

        def counted(name):
            def wrap(real):
                def call(*a, **kw):
                    probe.calls[name] += 1
                    return real(*a, **kw)
                return call
            return wrap

        def timed(store, with_bytes=False):
            def wrap(real):
                def call(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.monotonic()
                    out = real(*a, **kw)
                    torch.cuda.synchronize()
                    secs = time.monotonic() - t
                    store.append((secs, checkpoint.checkpoint_bytes(out))
                                 if with_bytes else secs)
                    return out
                return call
            return wrap

        patch(WindFieldGAN, "train_step", on_step)
        patch(WindFieldGAN, "val_step", counted("val_step"))
        patch(WindFieldGAN, "generate", counted("generate"))
        patch(loop, "run_validation", timed(self.val_s))
        patch(checkpoint, "save_checkpoint", timed(self.saves, True))

    def step_ms(self, quiet):
        """Median ms from the start of one step to the next over the
        steps ``quiet(it)`` accepts, G and D apart."""
        out = {}
        for g in (True, False):
            ms = [a[2].elapsed_time(b[2]) for a, b in
                  zip(self.steps, self.steps[1:]) if a[1] == g and quiet(a[0])]
            out["G" if g else "D"] = (statistics.median(ms), len(ms))
        return out


def leg_config(tmp, root, **training):
    """A copy of milestone9k with its folders in ``tmp`` (runs under
    ``root``), the pack's path made absolute, the schedule of a short leg
    and ``training`` overrides. Width, depth, batch, dtype, augmentation,
    device_resident_data and the warm start stay as committed."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(CFG)
    cfg.env.root_path = os.path.join(tmp, root)
    cfg.env.data_root = os.path.join(tmp, "data")
    cfg.env.generator_load_path = os.path.join(REPO,
                                               cfg.env.generator_load_path)
    for k, v in {**LEG_SCHEDULE, **training}.items():
        setattr(cfg.training, k, v)
    cfg.use_tensorboard_logger = False
    path = os.path.join(tmp, f"{root}.ini")
    cfg.save(path)
    return cfg, path


def tree_diffs(a, b):
    """Per tree of two states (G, its EMA, D, D's statistics, both Adam
    moments): (max abs difference, rel L2, bit-exact)."""
    import torch

    pairs = [(t, getattr(a, t), getattr(b, t)) for t in
             ("params_G", "params_G_ema", "params_D", "batch_stats_D")]
    pairs += [(f"{o}.{m}", getattr(getattr(a, o), m),
               getattr(getattr(b, o), m))
              for o in ("opt_state_G", "opt_state_D") for m in ("mu", "nu")]
    out = {}
    for name, ta, tb in pairs:
        fa, fb = (torch.cat([x[k].flatten().double() for k in ta])
                  for x in (ta, tb))
        out[name] = ((fa - fb).abs().max().item(), rel_l2(fa, fb),
                     all(torch.equal(ta[k], tb[k]) for k in ta))
    return out


def loop_phase(dev, card, bare, tmp):
    """Phase 7: python -m gan_sr_wind_field_tpu_torch.run --train on a copy
    of milestone9k in ``tmp``, from the 6k pack, 16 steps; then the
    checkpoint round trip and a resumed leg. Returns the leg's launches,
    its live state at the end and the path of its last checkpoint."""
    import shutil

    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.data import preprocess
    from gan_sr_wind_field_tpu_torch.data.augment import augment_batch
    from gan_sr_wind_field_tpu_torch.data.device_data import (
        load_resident_volumes,
        slice_batch,
    )
    from gan_sr_wind_field_tpu_torch.data.synthetic import (
        generate_synthetic_cache,
    )
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt

    cfg, ini = leg_config(tmp, "leg")
    g, n = cfg.gan_config, cfg.dataset_train.batch_size
    hours, size = int(LEG_DATA[1]), int(LEG_DATA[3])
    log(f"loop: {os.path.basename(CFG)} copy, it {LEG_FROM} -> {LEG_TO} "
        f"from the 6k pack, schedule {LEG_SCHEDULE}, data {hours} h at "
        f"{size}x{size}x{g.number_of_z_layers}")
    # the data feed, each part alone; the leg then finds them built
    t = time.monotonic()
    generate_synthetic_cache(cfg.env.data_root, hours, size, size,
                             g.number_of_z_layers)
    s_cache = time.monotonic() - t
    t = time.monotonic()
    ds_train, _, ds_val, _, _ = preprocess(
        cfg, synthetic=True, synthetic_hours=hours, synthetic_size=size)
    s_pre = time.monotonic() - t
    t = time.monotonic()
    ds_train.use_npcache()  # builds the memmap of the train split
    s_npc = time.monotonic() - t
    t = time.monotonic()
    full, zraw = load_resident_volumes(ds_train)
    s_host = time.monotonic() - t
    torch.cuda.synchronize()
    t = time.monotonic()
    full_d = torch.from_numpy(full).to(dev)
    zraw_d = torch.from_numpy(zraw).to(dev)
    torch.cuda.synchronize()
    s_up = time.monotonic() - t
    mb = (full.nbytes + zraw.nbytes) / 1e6
    n_val = len(ds_val)
    del full, zraw
    log(f"  data feed: synthetic cache {s_cache:.3f} s, preprocess "
        f"{s_pre:.3f} s, npcache {s_npc:.3f} s, resident volumes on the "
        f"host {s_host:.3f} s, upload {s_up:.3f} s ({mb:.1f} MB, "
        f"{len(ds_train)} train / {len(ds_val)} val volumes) ({card})")
    gen = torch.Generator(device=dev).manual_seed(0)

    def slice_and_augment():
        return augment_batch(gen, *slice_batch(
            full_d, zraw_d, gen, batch_size=n, patch=g.slice_size,
            patch_y=g.slice_size, cf=cfg.scale, enable_slicing=True))

    sa_ms = cuda_ms(slice_and_augment)
    lr, hr, z = slice_and_augment()
    if (lr.shape != (n, g.slice_size // cfg.scale, g.slice_size
                     // cfg.scale, g.number_of_z_layers,
                     cfg.lr_num_channels)
            or not all(bool(torch.isfinite(a).all())
                       for a in (lr, hr, z))):
        fail(f"bad device batch: {tuple(lr.shape)}")
    log(f"  one slice_batch + augment_batch at batch {n}: {sa_ms:.3f} ms "
        f"({card})")
    del full_d, zraw_d, lr, hr, z, ds_train, ds_val
    torch.cuda.empty_cache()

    # the leg, through the command line
    argv = ["--cfg", ini, "--train", "--synthetic", *LEG_DATA,
            "--max_steps", str(LEG_TO)]
    probe = LegProbe()
    reset_counters()
    t = time.monotonic()
    try:
        state = run.main(argv)
    finally:
        probe.close()
    torch.cuda.synchronize()
    leg_s = time.monotonic() - t
    launches = counters()
    if not probe.steps or probe.steps[0][3] != LEG_FROM:
        fail("the leg did not start at it "
             f"{LEG_FROM} from the pack")
    if state.it != LEG_TO:
        fail(f"the leg ended at it {state.it}, not {LEG_TO}")
    period = cfg.training.d_g_train_period
    ratio = cfg.training.d_g_train_ratio
    its = range(LEG_FROM + 1, LEG_TO + 1)
    n_g = sum((it // period) % (ratio + 1) == 0 for it in its)
    n_d = len(its) - n_g
    sweeps = sum(it % cfg.training.val_period == 0 for it in its)
    val_batches = sweeps * math.ceil(n_val / cfg.dataset_val.batch_size)
    want_calls = {"val_step": val_batches, "generate": sweeps}
    if ([s[1] for s in probe.steps] != [(it // period) % (ratio + 1) == 0
                                         for it in its]
            or probe.calls != want_calls):
        fail(f"the leg's calls {probe.calls}, steps "
             f"{[s[0] for s in probe.steps]} are not the schedule's")
    predicted = tuple(
        n_g * a + n_d * b + val_batches * c + sweeps * e
        for a, b, c, e in zip(G_STEP_LAUNCHES, D_STEP_LAUNCHES,
                              VAL_LAUNCHES, GENERATE_LAUNCHES))
    log(f"  leg {LEG_FROM} -> {LEG_TO} in {leg_s:.1f} s: {n_g} G steps, "
        f"{n_d} D steps, {val_batches} validation batches, {sweeps} "
        f"generate calls; launches {LAUNCH_LABELS} {launches}, "
        f"predicted {predicted}")
    if launches != predicted:
        fail(f"the leg launched {launches}, predicted {predicted}")

    # what the run wrote: losses on every logged line, two validations,
    # the two checkpoints kept
    run_folder = cfg_run_folder(tmp, "leg")
    with open(os.path.join(tmp, "leg", "log", "status.log")) as f:
        status = f.read()
    logged = re.findall(r"it (\d+) G_total (\S+) D (\S+) .*"
                        r"\((\S+) Mvox/s\)", status)
    vals = re.findall(r"validation it (\d+): PSNR (\S+) \(trilinear "
                      r"(\S+)\) G_total (\S+)", status)
    if ([int(r[0]) for r in logged]
            != list(range(LEG_FROM + 4, LEG_TO + 1, 4))
            or not all(math.isfinite(float(v)) for r in logged
                       for v in r[1:3])):
        fail(f"logged lines {logged}")
    if [int(v[0]) for v in vals] != [LEG_FROM + 8, LEG_TO] or not all(
            math.isfinite(float(x)) for v in vals for x in v[1:]):
        fail(f"validation lines {vals}")
    if "continuation warm start" not in status or f"at it={LEG_FROM}" \
            not in status:
        fail("no warm start from the pack in the status log")
    kept = sorted(d for d in os.listdir(run_folder)
                  if d.startswith("ckpt_"))
    if kept != [f"ckpt_{LEG_FROM + 8}", f"ckpt_{LEG_TO}"]:
        fail(f"checkpoints kept: {kept}")

    # times: steady state over iterations without boundary work
    quiet = (lambda it: it != LEG_FROM + 1
             and it % cfg.training.log_period
             and it % cfg.training.val_period
             and it % cfg.training.save_model_period)
    per = probe.step_ms(quiet)
    vox = n * g.slice_size * g.slice_size * g.number_of_z_layers
    for kind, bare_ms in (("G", bare["g_ms"]), ("D", bare["d_ms"])):
        ms, count = per[kind]
        log(f"  loop {kind} step {ms:.3f} ms (median of {count} "
            f"iterations without boundary work, CUDA events from one "
            f"step's start to the next), bare train_step {bare_ms:.3f} "
            f"ms (phase 6): the loop's own cost {ms - bare_ms:.3f} ms "
            f"per step ({card})")
    mean_ms = (per["G"][0] + per["D"][0]) / 2
    log(f"  loop HR voxels/s {vox / (mean_ms / 1e3):.4e} over a G/D "
        f"alternation (steady state); as logged "
        + ", ".join(f"it {r[0]} {float(r[3]) * 1e6:.4e}" for r in logged)
        + f" ({card})")
    log(f"  validation sweep {probe.val_s[-1]:.3f} s (first "
        f"{probe.val_s[0]:.3f} s; {val_batches // sweeps} batch of "
        f"{min(n_val, cfg.dataset_val.batch_size)} and one generate); "
        f"checkpoint save {probe.saves[-1][0]:.3f} s, "
        f"{probe.saves[-1][1]} bytes ({card})")

    # the checkpoint round trip
    restored = ckpt.restore_checkpoint(
        os.path.join(run_folder, f"ckpt_{LEG_TO}"), state)
    rt = tree_diffs(restored, state)
    same_rng = torch.equal(restored.rng.get_state(), state.rng.get_state())
    log(f"  restore_checkpoint(ckpt_{LEG_TO}) vs the live state: "
        f"bit-exact {all(v[2] for v in rt.values())}, generator "
        f"state equal {same_rng}, it {restored.it}")
    if not (all(v[2] for v in rt.values()) and same_rng
            and restored.it == state.it
            and restored.opt_state_G.count == state.opt_state_G.count):
        fail("the checkpoint round trip is not bit-exact")
    del restored

    # a resumed leg from ckpt_6008, in a copy of the run folder
    copy = os.path.join(tmp, "resume_from")
    shutil.copytree(run_folder, copy,
                    ignore=shutil.ignore_patterns(f"ckpt_{LEG_TO}"))
    cfg2, ini2 = leg_config(
        tmp, "resumed", resume_training_from_save=True)
    cfg2.env.state_load_path = os.path.join(copy, f"ckpt_{LEG_FROM + 8}")
    cfg2.save(ini2)
    probe = LegProbe()
    try:
        resumed = run.main(["--cfg", ini2, "--train", "--synthetic",
                            *LEG_DATA, "--max_steps", str(LEG_TO)])
    finally:
        probe.close()
    if probe.steps[0][3] != LEG_FROM + 8 or resumed.it != LEG_TO:
        fail(f"the resumed leg ran {probe.steps[0][3]} -> {resumed.it}")
    diffs = tree_diffs(resumed, state)
    exact = all(v[2] for v in diffs.values()) and torch.equal(
        resumed.rng.get_state(), state.rng.get_state())
    for name, (mx, rel, bits) in diffs.items():
        log(f"  resumed vs uninterrupted {name:<18} max abs {mx:.3e}, "
            f"rel L2 {rel:.3e}, bit-exact {bits}")
    log(f"  resumed leg from ckpt_{LEG_FROM + 8}: bit-exact {exact}")
    if not exact and not all(v[1] <= RESUME_TOL for v in diffs.values()):
        fail(f"the resumed leg is off by more than {RESUME_TOL:.0e}")
    del resumed
    return launches, state, os.path.join(run_folder, f"ckpt_{LEG_TO}"), per


def cfg_run_folder(tmp, root):
    """The one run folder the command line made under ``tmp/root``."""
    runs = os.path.join(tmp, root, "runs")
    (name,) = os.listdir(runs)
    return os.path.join(runs, name)


# phase 8: evaluate, use and serve what the port trains. The held-out test
# chain runs on configs/test_milestone6k.ini's data (phase 7's synthetic
# cache: 240 h at 128x128x10, 23 test fields) with the committed 6k pack, and
# is held against the JAX package's own --test result on a TPU
TEST_CFG = os.path.join(REPO, "configs", "test_milestone6k.ini")
PACK_6K = os.path.join(REPO, "docs", "evidence",
                       "milestone6k_continuation_6000.npz")
JAX_TEST = os.path.join(REPO, "docs", "evidence", "milestone6k_test_{}.csv")
TEST_FIELDS = 23
# trilinear does not depend on the weights; the model rows allow for the
# pack's bf16 rounding of the float32 ckpt_6000 and for bf16 convs on
# another chip; the HR-head kernel against the module head on one pass
TRILINEAR_TOL_DB = 1e-3
MODEL_TOL_DB = 0.3
HEAD_PSNR_TOL_DB = 0.05
HEAD_FIELD_TOL = 3e-2


class GenerateProbe:
    """Counts ``WindFieldGAN.generate`` calls and keeps, on the host, each
    output, the first call's inputs and the last call's GAN and state."""

    def __init__(self):
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        self.outputs, self.first, self.last = [], None, None
        self._real = real = WindFieldGAN.generate
        probe = self

        def generate(gan, state, lr, z):
            out = real(gan, state, lr, z)
            probe.outputs.append(out.float().cpu())
            if probe.first is None:
                probe.first = (lr, z)
            probe.last = (gan, state)
            return out

        WindFieldGAN.generate = generate

    def close(self):
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        WindFieldGAN.generate = self._real


def jax_test_result():
    """The JAX package's committed --test result (on a TPU): the averages
    rows by name, and each per-field PSNR by track and field."""
    import csv

    with open(JAX_TEST.format("averages")) as f:
        rows = list(csv.reader(f, skipinitialspace=True))
    avgs = {r[0]: [float(v) for v in r[1:]] for r in rows[1:]}
    fields = {}
    for track in ("metrics", "metrics_ema"):
        with open(JAX_TEST.format(track)) as f:
            fields[track] = {r[0]: float(r[1]) for r in
                             list(csv.reader(f, skipinitialspace=True))[1:]}
    return avgs, fields


def read_metrics(path):
    """(header line, {field: PSNR}) of a metrics CSV the port wrote."""
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0] + "\n", {ln.split(",")[0]: float(ln.split(",")[1])
                             for ln in lines[1:]}


def test_copy(tmp, root, **flags):
    """A copy of test_milestone6k.ini with the 6k pack as its weights, its
    folders in ``tmp`` (runs under ``root``) and phase 7's data."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(TEST_CFG)
    cfg.env.generator_load_path = PACK_6K
    cfg.env.root_path = os.path.join(tmp, root)
    cfg.env.this_runs_folder = os.path.join(tmp, root, "runs", "unset")
    cfg.env.data_root = os.path.join(tmp, "data")
    cfg.use_tensorboard_logger = False
    for k, v in flags.items():
        setattr(cfg, k, v)
    path = os.path.join(tmp, f"{root}.ini")
    cfg.save(path)
    return path


def cli_pass(label, cwd, *argv):
    """run.main(argv) in ``cwd`` on phase 7's data; → (its result, the
    GenerateProbe, the launches, wall seconds)."""
    import torch

    from gan_sr_wind_field_tpu_torch import run

    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    probe = GenerateProbe()
    reset_counters()
    t = time.monotonic()
    try:
        os.chdir(cwd)
        out = run.main([*argv, "--synthetic", *LEG_DATA])
        torch.cuda.synchronize()
    finally:
        os.chdir(old)
        probe.close()
    secs = time.monotonic() - t
    launches = counters()
    log(f"  {label}: {len(probe.outputs)} generate calls in {secs:.3f} s "
        f"wall; launches {LAUNCH_LABELS} {launches}")
    want = (len(probe.outputs), 0, 0, 0,
            len(probe.outputs) if "head" in label else 0)
    if len(probe.outputs) != TEST_FIELDS or launches != want:
        fail(f"{label} made {len(probe.outputs)} generate calls and "
             f"launched {launches}, predicted {want}")
    return out, probe, launches, secs


def check_trunk_on_field(ini, probe, dev):
    """The trunk kernel on the trunk input of the first field a test pass
    generated (batch 1 at LR 32x32x10, nf 128, its state's G) against its
    plain version in the same dtype: the increment within 3e-2, as phase 3
    holds it. No count is read: the pass's own run is over."""
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.models.fused_apply import trunk_geometry
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        rrdb_trunk,
        rrdb_trunk_reference,
    )

    G = generator_from_config(load_config(ini), device=dev)
    G.load_state_dict(probe.last[1].params_G, strict=True)
    lr = torch.as_tensor(probe.first[0], device=dev)
    with torch.no_grad():
        x = G.feature_conv(lr.to(G.dtype)).contiguous()
        packed = pack_trunk_weights(G.rrdbs, G.dtype, dev)
        geom = trunk_geometry(G)
        got = rrdb_trunk(packed, x, **geom).float()
        want = rrdb_trunk_reference(packed, x, **geom).float()
    xf = x.float()
    log(f"  trunk kernel on the test field's trunk input {tuple(x.shape)} "
        f"{x.dtype}, {len(G.rrdbs)} RRDB: max abs "
        f"{(got - want).abs().max().item():.3e} of max |out| "
        f"{want.abs().max().item():.3e}")
    check("trunk kernel vs plain at the test volume (increment)",
          rel_l2(got - xf, want - xf), 3e-2)
    del G, packed, got, want
    torch.cuda.empty_cache()


def eval_phase(dev, card, tmp, state, ckpt_path):
    """Phase 8: pack the live state of phase 7 and read it back, serve its
    ckpt_6016 (from_checkpoint and the server's --checkpoint), then the
    held-out test chain, --test_ema, a pass through the HR-head kernel and
    --use, as a user runs them (run.main in process). Returns the trunk
    and head kernels' launches and times."""
    import dataclasses
    import pickle

    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval import server
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.test_loop import (
        AVG_HEADER,
        METRIC_HEADER,
    )
    from gan_sr_wind_field_tpu_torch.train.continuation import (
        load_continuation,
        pack_from_state,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    from gan_sr_wind_field_tpu_torch.utils.jax_params import (
        d_params_from_jax,
        params_from_jax,
    )

    # 1. the pack of the live state, written in two threads (zlib, the
    # bulk of a write, runs without the GIL) while steps 2 to 5 run; read
    # back before step 6 times anything
    from concurrent.futures import ThreadPoolExecutor

    want = {"G": state.params_G, "Gema": state.params_G_ema,
            "D": {**state.params_D, **state.batch_stats_D}}

    def write(store):
        t0 = time.monotonic()
        out = pack_from_state(os.path.join(tmp, f"pack_{store}.npz"), state,
                              store_dtype=store)
        return out, time.monotonic() - t0

    t_packs = time.monotonic()
    pool = ThreadPoolExecutor(max_workers=2)
    writes = {store: pool.submit(write, store)
              for store in ("float32", "bfloat16")}
    pool.shutdown(wait=False)

    def check_packs():
        for store, future in writes.items():
            path, secs = future.result()
            pack = load_continuation(path)
            got = {"G": params_from_jax(pack["params_G"]),
                   "Gema": params_from_jax(pack["params_G_ema"]),
                   "D": d_params_from_jax(pack["params_D"],
                                          pack["batch_stats_D"])}
            exact = {}
            for tree, ref in want.items():
                exact[tree] = sorted(got[tree]) == sorted(ref) and all(
                    torch.equal(got[tree][k], v.cpu() if store == "float32"
                                else v.cpu().to(torch.bfloat16).float())
                    for k, v in ref.items())
            log(f"  pack_from_state(it {state.it}) in {store}: "
                f"{os.path.getsize(path)} bytes in {secs:.3f} s; read back "
                f"bit for bit {exact}, it {pack['it']}")
            if not all(exact.values()) or pack["it"] != state.it:
                fail(f"the {store} pack does not read back as the state")
        log(f"  the two packs written beside steps 2-5, done "
            f"{time.monotonic() - t_packs:.3f} s after their start")

    # 2. serve ckpt_6016: from_checkpoint, and the server's --checkpoint
    run_cfg = os.path.join(os.path.dirname(ckpt_path), "config.ini")
    cfg = load_config(run_cfg)
    g = cfg.gan_config
    coords = np.arange(g.slice_size, dtype=np.float32)
    sr = WindFieldSR.from_checkpoint(cfg, ckpt_path, coords, coords,
                                     device=dev)
    lr_xy = g.slice_size // cfg.scale
    lr, z = sample(np.random.default_rng(2008), 8, lr_xy, g.slice_size,
                   g.number_of_z_layers, cfg.lr_num_channels)
    reset_counters()
    got = sr.upscale(lr, z)
    serve_launches = counters()
    if serve_launches != (1, 0, 0, 0, 0) or not np.isfinite(got).all():
        fail(f"from_checkpoint served with launches {serve_launches}")
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    ref = gan.generate(dataclasses.replace(state,
                                           params_G=state.params_G_ema),
                       lr, z).cpu().numpy()
    exact = np.array_equal(got, ref)
    log(f"  from_checkpoint(ckpt_{state.it}) served 8 samples, launches "
        f"{LAUNCH_LABELS} {serve_launches}; vs gan.generate with the "
        f"state's EMA: bit-exact {exact}, max abs "
        f"{np.abs(got - ref).max():.3e}")
    if not exact:
        fail("from_checkpoint does not serve the state's EMA bit for bit")
    del sr, gan, ref
    captured = {}
    real_serve = server.serve
    server.serve = lambda backend, **kw: captured.update(backend=backend)
    try:
        server.main(["--cfg", run_cfg, "--checkpoint", ckpt_path,
                     "--port", "0"])
    finally:
        server.serve = real_serve
    same = np.array_equal(captured["backend"].upscale(lr, z), got)
    log(f"  eval/server.py --checkpoint: backend built, its batch of 8 "
        f"equal to from_checkpoint's {same}")
    if not same:
        fail("the server's --checkpoint backend serves other weights")
    del captured
    torch.cuda.empty_cache()

    # 3. the held-out test chain as a user runs it
    avgs_jax, fields_jax = jax_test_result()
    jax_raw, jax_ema = avgs_jax["milestone6k"], avgs_jax["milestone6k_ema"]
    copy_ini = test_copy(tmp, "test")
    cwd = os.path.join(tmp, "cwd")
    log(f"test chain: {os.path.basename(TEST_CFG)} copy with "
        f"{os.path.relpath(PACK_6K, REPO)}, data {LEG_DATA[1]} h at "
        f"{LEG_DATA[3]}x{LEG_DATA[3]}x{g.number_of_z_layers} ({card})")
    raw, raw_probe, raw_launches, test_s = cli_pass(
        "--test", cwd, "--cfg", copy_ini, "--test")
    ema, _, ema_launches, ema_s = cli_pass(
        "--test --test_ema", cwd, "--cfg", copy_ini, "--test", "--test_ema")
    out = os.path.join(cwd, "test_output")
    with open(os.path.join(out, "averages.csv")) as f:
        avg_lines = f.read().splitlines()
    for line in avg_lines[1:]:
        log(f"  averages row: {line}")
    if (avg_lines[0] + "\n" != AVG_HEADER
            or [ln.split(",")[0] for ln in avg_lines[1:]]
            != ["milestone6k", "milestone6k_ema"]):
        fail(f"averages.csv: {avg_lines}")
    for track, name in (("metrics", "milestone6k"),
                        ("metrics_ema", "milestone6k_ema")):
        header, psnr = read_metrics(os.path.join(out,
                                                 f"{name}____metrics.csv"))
        if header != METRIC_HEADER or len(psnr) != TEST_FIELDS:
            fail(f"{name}____metrics.csv: {len(psnr)} rows, header "
                 f"{header!r}")
        gaps = {f: psnr[f] - fields_jax[track][f] for f in fields_jax[track]}
        worst = max(gaps, key=lambda f: abs(gaps[f]))
        log(f"  {name}: largest per-field PSNR gap to the JAX package's "
            f"{os.path.basename(JAX_TEST.format(track))} {gaps[worst]:+.4f} "
            f"dB ({worst})")
    checks = (
        ("trilinear PSNR", raw["PSNR_trilinear"], jax_raw[1],
         TRILINEAR_TOL_DB),
        ("raw G PSNR", raw["PSNR"], jax_raw[0], MODEL_TOL_DB),
        ("EMA PSNR", ema["PSNR"], jax_ema[0], MODEL_TOL_DB),
    )
    for what, mine, theirs, tol in checks:
        log(f"  {what}: port {mine:.6f} dB, JAX package on a TPU "
            f"{theirs:.6f} dB, gap {mine - theirs:+.6f} (tol {tol})")
        if not abs(mine - theirs) <= tol:
            fail(f"{what} is {mine - theirs:+.6f} dB off the JAX result")
    if not raw["PSNR"] > raw["PSNR_trilinear"]:
        fail("the raw generator does not beat trilinear on the test split")

    # the trunk kernel at the test volume's geometry against its plain
    # version, on the trunk input of the pass's first field
    check_trunk_on_field(copy_ini, raw_probe, dev)

    # 4. the same pass through the HR-head kernel (use_pallas_head_nograd)
    head_ini = test_copy(tmp, "test_head", use_pallas_head_nograd=True)
    head, head_probe, head_launches, head_s = cli_pass(
        "--test, head kernel", os.path.join(tmp, "cwd_head"), "--cfg",
        head_ini, "--test")
    field_err = max(rel_l2(a, b) for a, b in
                    zip(head_probe.outputs, raw_probe.outputs))
    log(f"  head kernel vs module head: average PSNR {head['PSNR']:.6f} vs "
        f"{raw['PSNR']:.6f} dB (tol {HEAD_PSNR_TOL_DB}), largest per-field "
        f"SR rel L2 {field_err:.3e} (tol {HEAD_FIELD_TOL:.0e})")
    if not (abs(head["PSNR"] - raw["PSNR"]) <= HEAD_PSNR_TOL_DB
            and field_err <= HEAD_FIELD_TOL):
        fail("the head kernel's test pass disagrees with the module head")

    # 5. --use: the SR field dumps of the test split
    _, _, use_launches, use_s = cli_pass("--use", cwd, "--cfg", copy_ini,
                                         "--use")
    runs = os.path.join(tmp, "test", "runs")
    fields = os.path.join(runs, sorted(os.listdir(runs))[-1], "fields")
    dumps = sorted(os.listdir(fields))
    size, zl = int(LEG_DATA[3]), g.number_of_z_layers
    shapes = {"LR": (cfg.lr_num_channels, size // cfg.scale,
                     size // cfg.scale, zl), "SR": (3, size, size, zl)}
    for name in dumps:
        with open(os.path.join(fields, name), "rb") as f:
            d = pickle.load(f)
        if ({k: v.shape for k, v in d.items()} != shapes
                or not all(np.isfinite(v).all() for v in d.values())):
            fail(f"--use dump {name}: "
                 f"{ {k: v.shape for k, v in d.items()} }")
    log(f"  --use wrote {len(dumps)} dumps, {shapes}, finite")
    if len(dumps) != TEST_FIELDS:
        fail(f"--use wrote {len(dumps)} dumps")

    check_packs()
    # 6. times of one full-volume generate, module head and head kernel
    per_field = {}
    for label, probe in (("module head", raw_probe),
                         ("head kernel", head_probe)):
        gan_p, state_p = probe.last
        lr1, z1 = probe.first
        per_field[label] = cuda_ms(lambda: gan_p.generate(state_p, lr1, z1))
    field = tuple(torch.as_tensor(t).cpu().numpy()[0]
                  for t in raw_probe.first)
    del raw_probe, head_probe, gan_p, state_p
    log(f"  generate of one {size}x{size}x{zl} field: module head "
        f"{per_field['module head']:.3f} ms, head kernel "
        f"{per_field['head kernel']:.3f} ms; test pass {test_s:.3f} s, EMA "
        f"pass {ema_s:.3f} s, head-kernel pass {head_s:.3f} s, --use "
        f"{use_s:.3f} s wall ({card})")
    passes = (serve_launches, raw_launches, ema_launches, head_launches,
              use_launches)
    return {"trunk": sum(n[0] for n in passes),
            "head": sum(n[4] for n in passes), "ms_module_head":
            per_field["module head"], "ms_head_kernel":
            per_field["head kernel"], "test_s": test_s,
            "psnr": raw["PSNR"], "psnr_ema": ema["PSNR"],
            "psnr_trilinear": raw["PSNR_trilinear"], "field": field}


# phase 9: the long runs' loop and SR of any extent, in phase 7's temporary
# directory on its data. (a) phase 7's leg chunked (steps_per_dispatch 4,
# CUDA graphs of the step) and profiled, 6000 -> 6008: 6001-6004 G, G, G, D
# and 6005-6008 D, D, D, G, each kind warmed up and captured on its first
# use (6001, 6004) and replayed after (3 G and 3 D replays); (b) the host
# data path, 6000 -> 6004 per step (G, G, G, D); (c) upscale_tiled at the
# server's tile (the training LR patch)
CHUNK_STEPS, CHUNK_TO, HOST_TO = 4, LEG_FROM + 8, LEG_FROM + 4
# 4 G, 4 D, one validation batch and one generate
CHUNK_LAUNCHES = (10, 4, 10, 4, 0)
CHUNK_REPLAYS = 6
HOST_LAUNCHES = (4, 3, 6, 3, 0)      # 3 G, 1 D, no validation
TILE, OVERLAP, TILE_BATCH = 16, 4, 8
TILED_HOST_TOL = 1e-6  # the same kernel on the same tiles, blended apart
# median |tiled - direct| / std(direct), JAX's bound (tests/test_serve.py)
TILED_MEDIAN_RATIO = 0.25
BIG_FIELD = 128                      # LR 128x128: HR 512x512


class ChunkProbe(Patches):
    """What a chunked leg dispatches: each train_chunk call (its first
    iteration and length), and for each step through the graphs a CUDA
    event at its start, its iteration, its kind and whether its graph
    replayed; the graphs themselves."""

    def __init__(self):
        import torch

        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
        from gan_sr_wind_field_tpu_torch.train.step_graphs import StepGraphs

        super().__init__()
        self.chunks, self.steps, self.graphs = [], [], None
        probe = self
        patch = self.patch

        def on_chunk(real):
            def chunk(gan, state, *a, n_steps, **kw):
                probe.chunks.append((state.it, n_steps))
                return real(gan, state, *a, n_steps=n_steps, **kw)
            return chunk

        def on_step(real):
            def step(graphs, state, batch):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                it = state.it + 1
                g = graphs.gan.is_g_step(it)
                probe.steps.append((it, g, ev, g in graphs.graphs))
                probe.graphs = graphs
                return real(graphs, state, batch)
            return step

        patch(WindFieldGAN, "train_chunk", on_chunk)
        patch(StepGraphs, "step", on_step)

    def replay_ms(self, quiet):
        """Median ms from the start of a replayed step to the next step's
        start over the steps ``quiet(it)`` accepts, G and D apart."""
        out = {}
        for g in (True, False):
            ms = [a[2].elapsed_time(b[2]) for a, b in
                  zip(self.steps, self.steps[1:])
                  if a[1] == g and a[3] and quiet(a[0])]
            out["G" if g else "D"] = (statistics.median(ms), len(ms))
        return out


def read_trace(path):
    """From a torch.profiler Chrome trace: (the window's ms, the card's
    busy ms (the union of its kernels, copies and sets), {device op name:
    (ms, count)})."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, ops = 0.0, -math.inf, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = ops.get(name, (0.0, 0))
        ops[name] = (ms + (b - a) / 1e3, n + 1)
    return (t1 - t0) / 1e3, busy / 1e3, ops


def chunk_phase(dev, card, tmp, leg_ms, field):
    """Phase 9: (a) phase 7's leg chunked through CUDA graphs and
    profiled, held against phase 7's ckpt_6008; (b) the host data path
    leg; (c) upscale_tiled on the 6k pack, a test field and a 512x512
    field, with the module head and through kernel 5. Returns each
    kernel's launches on these paths."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR, _tiling
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
    from gan_sr_wind_field_tpu_torch.train import loop

    # (a) the chunked leg, profiled
    cfg, ini = leg_config(tmp, "chunked")
    cfg.steps_per_dispatch = CHUNK_STEPS
    cfg.save(ini)
    log(f"chunked leg: the phase-7 leg with steps_per_dispatch "
        f"{CHUNK_STEPS}, it {LEG_FROM} -> {CHUNK_TO}, --profile")
    probe = ChunkProbe()
    reset_counters()
    t = time.monotonic()
    try:
        state = run.main(["--cfg", ini, "--train", "--profile",
                          "--synthetic", *LEG_DATA,
                          "--max_steps", str(CHUNK_TO)])
    finally:
        probe.close()
    torch.cuda.synchronize()
    leg_s = time.monotonic() - t
    launches = counters()
    graphs = probe.graphs
    log(f"  dispatches (it, steps) {probe.chunks}; steps "
        + ", ".join(f"{it} {'G' if g else 'D'}"
                    f"{' replay' if r else ' warm-up + capture'}"
                    for it, g, _, r in probe.steps))
    log(f"  leg {LEG_FROM} -> {CHUNK_TO} in {leg_s:.1f} s; launches "
        f"{LAUNCH_LABELS} {launches} (replays counted), predicted "
        f"{CHUNK_LAUNCHES}; {graphs.replays} graph replays, capture "
        f"{graphs.capture_s:.3f} s, pool {graphs.pool_bytes} bytes "
        f"({card})")
    if (state.it != CHUNK_TO
            or probe.chunks != [(LEG_FROM, CHUNK_STEPS),
                                (LEG_FROM + 4, CHUNK_STEPS)]):
        fail(f"the chunked leg ran {probe.chunks} to it {state.it}")
    if launches != CHUNK_LAUNCHES or graphs.replays != CHUNK_REPLAYS:
        fail(f"the chunked leg launched {launches} with {graphs.replays} "
             f"replays, predicted {CHUNK_LAUNCHES} and {CHUNK_REPLAYS}")
    with open(os.path.join(tmp, "chunked", "log", "status.log")) as f:
        status = f.read()
    logged = re.findall(r"it (\d+) G_total (\S+) D (\S+)", status)
    if ([int(r[0]) for r in logged] != [LEG_FROM + 4, CHUNK_TO]
            or not all(math.isfinite(float(v)) for r in logged
                       for v in r[1:])
            or f"validation it {CHUNK_TO}" not in status):
        fail(f"the chunked leg logged {logged}")
    per = probe.replay_ms(lambda it: it % CHUNK_STEPS)
    for kind in ("G", "D"):
        ms, n = per[kind]
        log(f"  chunked loop {kind} step {ms:.3f} ms (median of {n} "
            f"replays, start to next start), phase 7's per-step loop "
            f"{leg_ms[kind][0]:.3f} ms ({card})")
    ref = ckpt.restore_checkpoint(os.path.join(
        cfg_run_folder(tmp, "leg"), f"ckpt_{CHUNK_TO}"), state)
    diffs = tree_diffs(state, ref)
    same_rng = torch.equal(state.rng.get_state(), ref.rng.get_state())
    for name, (mx, rel, bits) in diffs.items():
        log(f"  chunked vs phase 7's ckpt_{CHUNK_TO} {name:<18} max abs "
            f"{mx:.3e}, rel L2 {rel:.3e}, bit-exact {bits}")
    exact = all(v[2] for v in diffs.values()) and same_rng
    held = exact or all(v[1] <= RESUME_TOL for v in diffs.values())
    log(f"  chunked leg at {CHUNK_TO} vs phase 7's ckpt_{CHUNK_TO}: "
        f"bit-exact {exact} (generator state equal {same_rng}); "
        f"{'bit-exact' if exact else f'within {RESUME_TOL:.0e}'} holds "
        f"{held}")
    if not held or ref.it != state.it:
        fail(f"the chunked leg is off by more than {RESUME_TOL:.0e}")
    del ref, state
    tb = os.path.join(tmp, "chunked", "tensorboard_log")
    (name,) = os.listdir(tb)
    trace = os.path.join(tb, name,
                         f"profile_it{LEG_FROM}-{CHUNK_TO}.pt.trace.json")
    if not os.path.exists(trace):
        fail(f"no trace at {trace}: {os.listdir(os.path.join(tb, name))}")
    window, busy, ops = read_trace(trace)
    log(f"  trace {os.path.getsize(trace)} bytes: the window {window:.1f} "
        f"ms, the card busy {busy:.1f} ms ({100 * busy / window:.1f} %) "
        f"({card})")
    for op, (ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]:
        log(f"    {ms:10.3f} ms {n:6d}x {op[:90]}")
    named = {k: sorted({n for n in ops if any(s in n for s in subs)})
             for k, subs in (
                 ("kernel 1", TC_KERNELS["rdb_trunk"]),
                 ("kernel 2", TC_KERNELS["rdb_trunk_bwd"]),
                 ("kernel 3", (STENCIL_KERNELS["gradient"],)),
                 ("kernel 4", (STENCIL_KERNELS["adjoint"],)))}
    log("  the trace names " + "; ".join(
        f"{k}: {', '.join(n[:40] for n in v) or 'none'}"
        for k, v in named.items()))
    if not all(named.values()):
        fail("the trace misses a kernel of the chunked leg")

    # (b) the host data path, per step
    cfg, ini = leg_config(tmp, "hostpath")
    cfg.device_resident_data = False
    cfg.save(ini)
    feeds = []

    def keep(real):
        def feed(*a, **kw):
            feeds.append(real(*a, **kw))
            return feeds[-1]
        return feed

    leg = LegProbe()
    leg.patch(loop, "prefetch_to_device", keep)
    reset_counters()
    try:
        state = run.main(["--cfg", ini, "--train", "--synthetic", *LEG_DATA,
                          "--max_steps", str(HOST_TO)])
    finally:
        leg.close()
    torch.cuda.synchronize()
    host = counters()
    with open(os.path.join(tmp, "hostpath", "log", "status.log")) as f:
        logged = re.findall(r"it (\d+) G_total (\S+) D (\S+)", f.read())
    g_quiet = [a[2].elapsed_time(b[2]) for a, b in
               zip(leg.steps, leg.steps[1:])
               if a[1] and a[0] != LEG_FROM + 1 and a[0] % 4]
    g_ms, n_g = statistics.median(g_quiet), len(g_quiet)
    log(f"  host data path {LEG_FROM} -> {HOST_TO}: launches "
        f"{LAUNCH_LABELS} {host}, predicted {HOST_LAUNCHES}; logged "
        f"{logged}; loop G step {g_ms:.3f} ms (median of {n_g}), phase "
        f"7's resident leg {leg_ms['G'][0]:.3f} ms; the loop waited "
        f"{feeds[0].wait_s:.3f} s on the prefetch queue (host clock) "
        f"({card})")
    if (state.it != HOST_TO or host != HOST_LAUNCHES
            or [int(r[0]) for r in logged] != [HOST_TO]
            or not all(math.isfinite(float(v)) for v in logged[0][1:])
            or feeds[0]._thread.is_alive()):
        fail(f"the host data path leg ended at {state.it}, launched {host}, "
             f"logged {logged}")
    del state
    torch.cuda.empty_cache()

    # (c) upscale_tiled at the server's tile, on the 6k pack
    mcfg = load_config(CFG)
    sr = WindFieldSR.from_continuation(mcfg, PACK_6K, use_ema=False,
                                       device=dev)
    hcfg = copy.deepcopy(mcfg)
    hcfg.use_pallas_head_nograd = True
    sr_h = WindFieldSR(hcfg, sr.G.state_dict(), device=dev)
    lr, z = field
    X, Y = lr.shape[:2]
    tile, win, coords = _tiling(X, Y, TILE, OVERLAP, TILE_BATCH, sr.scale)
    n_batches = math.ceil(len(coords) / TILE_BATCH)
    reset_counters()
    got = sr.upscale_tiled(lr, z, tile=TILE, overlap=OVERLAP,
                           batch=TILE_BATCH)
    tiled = counters()
    want = sr._upscale_tiled_host(lr, z, coords, tile, TILE_BATCH, win)
    direct = sr.upscale(lr, z)
    err_host = rel_l2(torch.from_numpy(got), torch.from_numpy(want))
    err_direct = rel_l2(torch.from_numpy(got), torch.from_numpy(direct))
    ratio = float(np.median(np.abs(got - direct)) / np.std(direct))
    log(f"upscale_tiled: test field LR {X}x{Y}x{lr.shape[2]}, tile "
        f"{TILE}, overlap {OVERLAP}, batch {TILE_BATCH}: {len(coords)} "
        f"tiles in {n_batches} batches, launches {LAUNCH_LABELS} {tiled}; "
        f"vs _upscale_tiled_host rel L2 {err_host:.3e} (tol "
        f"{TILED_HOST_TOL:.0e}); vs a direct upscale rel L2 "
        f"{err_direct:.3e}, median |err| / std {ratio:.3e} (JAX's bound "
        f"{TILED_MEDIAN_RATIO})")
    if (got.shape != direct.shape or not np.isfinite(got).all()
            or tiled != (n_batches, 0, 0, 0, 0)
            or not err_host <= TILED_HOST_TOL
            or not ratio <= TILED_MEDIAN_RATIO):
        fail("upscale_tiled on the test field")
    big_lr, big_z = (a[0] for a in sample(
        np.random.default_rng(2009), 1, BIG_FIELD, BIG_FIELD * sr.scale,
        lr.shape[2], lr.shape[3]))
    tile, _, coords = _tiling(BIG_FIELD, BIG_FIELD, TILE, OVERLAP,
                              TILE_BATCH, sr.scale)
    n_big = math.ceil(len(coords) / TILE_BATCH)
    vox = big_z.shape[0] * big_z.shape[1] * big_z.shape[2]
    big = {}
    for label, s_ in (("module head", sr), ("head kernel", sr_h)):
        reset_counters()
        t = time.monotonic()
        out = s_.upscale_tiled(big_lr, big_z, tile=TILE, overlap=OVERLAP,
                               batch=TILE_BATCH)
        n = counters()
        # three timed calls, one where the warm-up took over
        # VERY_LONG_CALL_S (as cuda_ms)
        reps = 1 if time.monotonic() - t > VERY_LONG_CALL_S else 3
        secs = []
        for _ in range(reps):
            t = time.monotonic()
            s_.upscale_tiled(big_lr, big_z, tile=TILE, overlap=OVERLAP,
                             batch=TILE_BATCH)
            secs.append(time.monotonic() - t)
        ms = 1e3 * statistics.median(secs)
        big[label] = (ms, n)
        log(f"  upscale_tiled HR {big_z.shape[0]}x{big_z.shape[1]}x"
            f"{big_z.shape[2]}, {label}: {len(coords)} tiles in {n_big} "
            f"batches, {ms:.3f} ms (median of {reps}, host clock, upload "
            f"and download included), {vox / (ms / 1e3):.4e} HR voxels/s; "
            f"launches {LAUNCH_LABELS} {n} ({card})")
        want_n = (n_big, 0, 0, 0, n_big if label == "head kernel" else 0)
        if (n != want_n or out.shape != (*big_z.shape[:3], 3)
                or not np.isfinite(out).all()):
            fail(f"upscale_tiled of the big field, {label}: launches {n}, "
                 f"predicted {want_n}")
    del sr, sr_h
    return {"chunk": launches, "host": host,
            "tiled": tuple(a + b + c for a, b, c in zip(
                tiled, big["module head"][1], big["head kernel"][1])),
            "tiled_ms": big["module head"][0],
            "tiled_head_ms": big["head kernel"][0]}




# phase 10: deploy what the port trains, in phase 7's temporary directory
# on its data, with a copy of configs/test_milestone6k.ini and the 6k pack:
# (a) the int8 conv kernels against their plain versions at every shape
# they serve at full width, and the head pair timed; (b) int8 serving
# through run.py --serve_int8 / --serve_int8_trunk; (c) the torch.export
# artifact through run.py --export (phase 8 runs --use) and
# eval/server.py --artifact; (d) eval.interp on the 9k and 6k packs
PACK_9K = os.path.join(REPO, "docs", "evidence",
                       "milestone9k_continuation_9000.npz")
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
# JAX's own bounds on int8 serving against the exact path, relative L2
# (tests/test_quant.py:156, tests/test_quant_trunk.py:153,160)
INT8_TOL = {"int8 head": 2e-2, "int8 trunk": 3e-2, "both": 4e-2}
# the JAX package's int8 head against its exact path on a TPU, in dB
# (gan_sr_wind_field_tpu/ops/quant.py:26): model quality, not speed
JAX_INT8_PSNR_DB = 67.7
EXPORT_PLAIN_TOL = 1e-5   # the artifact against the same aten ops
EXPORT_KERNEL_TOL = 3e-2  # against the kernel path: phase 4's bound


def int8_geometry(cfg):
    """The int8 kernels' widths at ``cfg``: the head's (nf, cm, stacked
    remainder columns, C, k, HR extent) and the trunk's (nf, gc, K, the
    RDB buffer's channels, LR extent), with the depth zl."""
    g, G = cfg.gan_config, cfg.generator
    hr, zl, k = g.slice_size, g.number_of_z_layers, G.hr_kern_size
    nf, gc, K = G.num_features, G.RDB_growth_chan, G.num_RDB_convs - 1
    C = nf + G.terrain_number_of_features
    cm = C // 128 * 128
    return dict(nf=nf, cm=cm, rem=k * k * (C - cm), C=C, k=k, hr=hr,
                lr=hr // cfg.scale, zl=zl, gc=gc, K=K, width=nf + gc * K)


def int8_tensors(dev, gen, shape, *sizes):
    """Seeded int8 tensors in [-127, 127] of ``shape`` + each size."""
    import torch

    return [torch.randint(-127, 128, (*shape, *sz), dtype=torch.int8,
                          device=dev, generator=gen) for sz in sizes]


def int8_scales(dev, gen, *cols):
    """Positive float32 scales of a served model's size, one per column."""
    import torch

    return [torch.rand(c, device=dev, generator=gen) * 1e-4 + 1e-6
            for c in cols]


def pair_work(rows, nf, cm, rem, k):
    """(int8 operations, bytes) of the head pair: the input read once, both
    weights read once, the main conv's bf16 columns and the remainder's
    float32 partials written once."""
    ops = 2 * rows * nf * (cm * k ** 3 + rem * k)
    nbytes = (rows * nf + nf * (cm * k ** 3 + rem * k) + 4 * (cm + rem)
              + rows * (2 * cm + 4 * rem))
    return ops, nbytes


def check_int8_kernel(cfg, dev, card, built):
    """Phase 10 (a): the conv_int8 library's ptxas report and IGMMA count
    (int8 wgmma; 0 fails); each entry point bit for bit against its plain
    version at the full-width shapes the serving paths give it (the head
    pair, the trunk's last growth conv into its RDB buffer, the LFF), each
    timed beside its bound; the LFF beside torch._int_mm on its operands
    (cuBLASLt, the same int32 sums); whether F.conv3d takes int8; the head
    pair at batch 8 and 32 beside its bound, its plain version, bf16 cuDNN
    of hr_conv0_x (the conv it replaces) and kernel 5. Returns {entry
    point: (max abs error, ms, plain ms, bound, library ms)} with the head
    pair's batch-32 numbers and kernel 5's under "pair_b32"."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.models.blocks import conv3d_cl
    from gan_sr_wind_field_tpu_torch.ops import conv_int8
    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        pack_head_weights,
    )

    path, _, report = built["conv_int8"]
    for fn, lines in ptxas_reports(report).items():
        log(f"  conv_int8 {fn} ptxas: {'; '.join(lines)}")
        if any("serialized" in line for line in lines):
            log(f"  conv_int8 {fn}: ptxas serializes its wgmmas")
    sass = sass_mma_counts(path)
    if sass is None:
        log("  conv_int8: cuobjdump not found, no SASS count")
    else:
        counts = [sum(c[i] for c in sass.values()) for i in range(4)]
        log(f"  conv_int8: {counts[3]} IGMMA (int8 wgmma) and {counts[2]} "
            f"IMMA instructions in its SASS")
        if counts[3] == 0:
            fail("conv_int8 has no int8 wgmma (IGMMA) in its SASS")
    gm = int8_geometry(cfg)
    nf, cm, rem, C, k, gc = (gm[v] for v in ("nf", "cm", "rem", "C", "k",
                                             "gc"))
    p = (k - 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2010)
    out = {}

    def report_call(name, label, shape, got, want, ms, plain_ms, ops, nbytes,
                    lib_ms):
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        bd = bound(ops, nbytes, H100_INT8_OPS)
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        log(f"  {label} at {shape}: bit for bit {exact} (max abs {err:.1e});"
            f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms{lib}; bound "
            f"{bd[0]:.4f} ms by {bd[1]} ({100 * bd[0] / ms:.1f} %), "
            f"{ops / ms / 1e9:.1f} TOP/s ({card})")
        if not exact:
            fail(f"conv_int8 {name} disagrees with its plain version at "
                 f"{label}")
        out[name] = (err, ms, plain_ms, bd, lib_ms)

    # the trunk's last growth conv and the LFF on one RDB buffer at LR
    # batch 8, then the head pair at HR batch 8
    lr_shape = (8, gm["lr"], gm["lr"], gm["zl"])
    rows = math.prod(lr_shape)
    (buf,) = int8_tensors(dev, gen, lr_shape, (gm["width"],))
    ci = nf + gc * (gm["K"] - 1)
    wg, wl = int8_tensors(dev, gen, (), (3, 3, 3, ci, gc), (1, 1, 1,
                                                            gm["width"], nf))
    sg, sl = int8_scales(dev, gen, gc, nf)
    sc = torch.rand(gc, device=dev, generator=gen) * 2.0 + 0.5
    bl = torch.randn(nf, device=dev, generator=gen)
    pg, pl = conv_int8.pack_conv_int8(wg), conv_int8.pack_conv_int8(wl)
    got, want = buf.clone(), buf.clone()  # each conv writes into its input
    conv_int8.conv3d_int8_requant(got, ci, wg, 1, sg, sc, 0.2, got, ci,
                                  packed=pg)
    conv_int8.conv3d_int8_requant_reference(want, ci, wg, 1, sg, sc, 0.2, want,
                                            ci)
    report_call(
        "requant", f"growth 3x3x3 {ci}->{gc} into columns {ci}.."
        f"{ci + gc - 1} of {gm['width']}", lr_shape, [got], [want],
        cuda_ms(lambda: conv_int8.conv3d_int8_requant(
            buf, ci, wg, 1, sg, sc, 0.2, buf, ci, packed=pg), reps=50),
        cuda_ms(lambda: conv_int8.conv3d_int8_requant_reference(
            buf, ci, wg, 1, sg, sc, 0.2, buf.clone(), ci), reps=2),
        2 * rows * 27 * ci * gc,
        rows * ci + 27 * ci * gc + 8 * gc + rows * gc, None)
    got = conv_int8.conv3d_int8(buf, wl, 0, sl, bl, packed=pl)
    want = conv_int8.conv3d_int8_reference(buf, wl, 0, sl, bl)
    a2 = buf.reshape(rows, gm["width"])
    b2 = wl.reshape(gm["width"], nf).t().contiguous().t()
    turns = alternate(
        lambda: conv_int8.conv3d_int8(buf, wl, 0, sl, bl, packed=pl),
        lambda: torch._int_mm(a2, b2))
    log_turns("  LFF kernel vs torch._int_mm (cuBLASLt) on its operands",
              turns, card)
    report_call(
        "lff", f"LFF 1x1x1 {gm['width']}->{nf} + bias", lr_shape, [got],
        [want], turns[0],
        cuda_ms(lambda: conv_int8.conv3d_int8_reference(buf, wl, 0, sl, bl),
                reps=2),
        2 * rows * gm["width"] * nf,
        rows * gm["width"] + gm["width"] * nf + 8 * nf + 4 * rows * nf,
        turns[1])
    if not torch.equal(torch._int_mm(a2, b2).reshape(*lr_shape, nf),
                       conv_int8.conv3d_int8_reference(buf, wl, 0)):
        fail("torch._int_mm does not give the LFF's int32 sums")
    del buf, wg, wl, got, want, a2, b2
    probe = torch.zeros((1, 32, 4, 4, 4), dtype=torch.int8, device=dev)
    try:
        F.conv3d(probe, torch.zeros((32, 32, 3, 3, 3), dtype=torch.int8,
                                    device=dev), padding=1)
        torch.cuda.synchronize()
        library_int8 = "accepted"
    except RuntimeError as e:
        library_int8 = f"refused ({str(e).splitlines()[0][:100]})"
    log(f"  F.conv3d on int8 CUDA tensors, torch {torch.__version__}: "
        f"{library_int8}")

    tc = cfg.generator.terrain_number_of_features
    for n in (8, 32):
        shape = (n, gm["hr"], gm["hr"], gm["zl"])
        (xq,) = int8_tensors(dev, gen, shape, (nf,))
        wm, wr = int8_tensors(dev, gen, (), (k, k, k, nf, cm), (1, 1, k, nf,
                                                               rem))
        sm, sr = int8_scales(dev, gen, cm, rem)
        pm, pr = conv_int8.pack_conv_int8(wm), conv_int8.pack_conv_int8(wr)

        def pair():
            return conv_int8.head_pair_int8(xq, wm, sm, p, wr, sr, width=C,
                                            packed_main=pm, packed_rem=pr)

        def plain():
            return conv_int8.head_pair_int8_reference(xq, wm, sm, p, wr, sr,
                                                      width=C)

        ms = cuda_ms(pair)
        plain_ms = cuda_ms(plain, reps=1)
        xb = torch.randn((*shape, nf), device=dev, generator=gen).to(
            torch.bfloat16)
        tb = torch.randn((*shape, tc), device=dev, generator=gen).to(
            torch.bfloat16)
        wx = (torch.randn((C, nf, k, k, k), device=dev, generator=gen)
              * 0.01).to(torch.bfloat16)
        wt = (torch.randn((C, tc, k, k, k), device=dev, generator=gen)
              * 0.01).to(torch.bfloat16)
        with torch.inference_mode():
            lib_ms = cuda_ms(lambda: conv3d_cl(xb, wx, p),
                             reps=5 if n == 8 else 3)
            packed5 = pack_head_weights(wx, wt, torch.bfloat16, dev)
            k5_ms = cuda_ms(lambda: hr_head_conv(packed5, xb, tb, k=k))
        del xb, tb, wx, wt, packed5
        ops, nbytes = pair_work(math.prod(shape), nf, cm, rem, k)
        if n == 8:
            (o, part), (wo, wpart) = pair(), plain()
            report_call("pair", f"head pair {k}x{k}x{k} {nf}->{cm} (bf16 "
                        f"into {C} columns) + 1x1x{k} {nf}->{rem} (float32)",
                        shape, [o[..., :cm], part], [wo[..., :cm], wpart], ms,
                        plain_ms, ops, nbytes, lib_ms)
            out["k5"] = k5_ms
            del o, part, wo, wpart
        else:
            out["pair_b32"] = (ms, plain_ms, bound(ops, nbytes,
                                                   H100_INT8_OPS), lib_ms,
                               k5_ms)
        bd = bound(ops, nbytes, H100_INT8_OPS)
        log(f"int8 head pair at batch {n} ({ops:.4e} int8 ops), one launch: "
            f"kernel {ms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]} "
            f"({100 * bd[0] / ms:.1f} %), plain {plain_ms:.3f} ms; the conv "
            f"it replaces, hr_conv0_x in bf16 cuDNN, {lib_ms:.3f} ms; kernel "
            f"5 (the whole bf16 head) {k5_ms:.3f} ms ({card})")
        del xq, wm, wr, pm, pr
        torch.cuda.empty_cache()
    return out


def plain_int8_paths():
    """A context in which the int8 serving functions run the plain versions
    of the int8 kernels' entry points (the composition the kernels replace)
    on the card's tensors."""
    import contextlib

    from gan_sr_wind_field_tpu_torch.ops import conv_int8, quant, quant_trunk

    @contextlib.contextmanager
    def ctx():
        saved = (quant.head_pair_int8, quant_trunk.conv3d_int8,
                 quant_trunk.conv3d_int8_requant)
        quant.head_pair_int8 = (
            lambda *a, packed_main=None, packed_rem=None, **kw:
            conv_int8.head_pair_int8_reference(*a, **kw))
        quant_trunk.conv3d_int8 = (
            lambda xq, wq, pad, s, bias=None, packed=None:
            conv_int8.conv3d_int8_reference(xq, wq, pad, s, bias))
        quant_trunk.conv3d_int8_requant = (
            lambda *a, packed=None: conv_int8.conv3d_int8_requant_reference(
                *a))
        try:
            yield
        finally:
            (quant.head_pair_int8, quant_trunk.conv3d_int8,
             quant_trunk.conv3d_int8_requant) = saved

    return ctx()


def psnr_db(got, ref):
    """PSNR of got against ref over ref's range, as the JAX package's
    probe computes it (scripts/probe_quant_serve.py:68-71)."""
    import numpy as np

    mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
    return 10 * math.log10(float(ref.max() - ref.min()) ** 2
                           / max(mse, 1e-30))


def deploy_phase(dev, card, tmp, built):
    """Phase 10: (a) ``check_int8_kernel``; (b) run.py --serve 0
    --serve_int8 8 --serve_int8_trunk 8 (its main in process, with
    eval.server.serve replaced to keep the backend) calibrates on the
    first 8 test fields, then one batch of 8 other test fields through
    the exact path, the int8 head, the int8 trunk and both, each held to
    JAX's bound with its launches as predicted, and each path's serving
    ms at batch 8 and 32 beside kernel 5's; (c) run.py --export, the
    artifact's bytes and seconds, eval/server.py --artifact's backend
    against the plain path and the kernel path at batch 1 and 8 and
    timed, and a torch-only subprocess that runs the payload; (d)
    eval.interp (its command line in another process, started before (b)):
    the endpoints reproduce each pack, alpha 0.5 serves."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(TEST_CFG)
    log(f"deploy: int8 conv kernel at {os.path.basename(TEST_CFG)}'s full "
        f"width ({card})")
    kernels = check_int8_kernel(cfg, dev, card, built)

    # (d) starts first: eval.interp's command line in another process, on
    # the card, while (b) and (c) run here
    ini = test_copy(tmp, "deploy")
    blend = os.path.join(tmp, "blend.wsrx")
    t_interp = time.monotonic()
    interp_proc = subprocess.Popen(
        [sys.executable, "-m", "gan_sr_wind_field_tpu_torch.eval.interp",
         "--cfg", ini, "--gan", PACK_9K, "--psnr", PACK_6K, "--alpha",
         "0.5", "--out", blend, "--device", str(dev)], cwd=REPO,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        return _deploy(dev, card, tmp, cfg, ini, blend, interp_proc,
                       t_interp, kernels)
    finally:
        if interp_proc.poll() is None:
            interp_proc.kill()
            interp_proc.wait()


def _deploy(dev, card, tmp, cfg, ini, blend, interp_proc, t_interp,
            kernels):
    """Phase 10 (b) to (d), beside the running eval.interp process."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval import interp, server
    from gan_sr_wind_field_tpu_torch.eval.export import (
        ExportedSR,
        load_exported,
        read_header,
    )
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

    # (b) int8 serving through the command line
    cwd = os.path.join(tmp, "cwd_deploy")
    os.makedirs(cwd, exist_ok=True)
    kept = {}
    real_serve, real_pre = server.serve, run.preprocess

    def keep_data(*a, **kw):
        kept["data"] = real_pre(*a, **kw)
        return kept["data"]

    server.serve = lambda backend, **kw: kept.update(backend=backend)
    run.preprocess = keep_data
    old = os.getcwd()
    t = time.monotonic()
    try:
        os.chdir(cwd)
        run.main(["--cfg", ini, "--serve", "0", "--serve_int8", "8",
                  "--serve_int8_trunk", "8", "--synthetic", *LEG_DATA])
    finally:
        os.chdir(old)
        server.serve, run.preprocess = real_serve, real_pre
    sr = kept.pop("backend")
    ds_test = kept.pop("data")[1]
    log(f"  run.py --serve 0 --serve_int8 8 --serve_int8_trunk 8: "
        f"calibrated on the first {min(8, len(ds_test))} of "
        f"{len(ds_test)} test fields, "
        f"backend ready in {time.monotonic() - t:.3f} s wall")
    if sr.qhead is None or sr.qtrunk is None:
        fail("--serve_int8[_trunk] did not calibrate the served backend")
    rng = np.random.default_rng(2013)
    # 8 other test fields, each cut to the training patch at its centre
    n_test = len(ds_test)
    fields = [ds_test.get((8 + i) % n_test, rng) for i in range(8)]
    p = cfg.gan_config.slice_size // cfg.scale
    o = (fields[0][0].shape[0] - p) // 2
    lr = np.stack([f[0][o:o + p, o:o + p] for f in fields])
    s = cfg.scale
    z = np.stack([f[2][s * o:s * (o + p), s * o:s * (o + p)]
                  for f in fields])
    qh, qt = sr.qhead, sr.qtrunk
    paths = {"bf16 module head": (None, None), "int8 head": (qh, None),
             "int8 trunk": (None, qt), "both": (qh, qt)}
    J = 3 * cfg.generator.num_RRDB
    per_trunk = J * cfg.generator.num_RDB_convs
    # one launch of the head pair; per RDB step the growth convs and the LFF
    want_launches = {"bf16 module head": (1, 0), "int8 head": (1, 1),
                     "int8 trunk": (0, per_trunk),
                     "both": (0, per_trunk + 1)}
    outs = {}
    reset_counters()
    for name, (h, q) in paths.items():
        sr.qhead, sr.qtrunk = h, q
        before = (counters()[0], counters()[4], int8_launches())
        outs[name] = sr.upscale(lr, z)
        got = (counters()[0] - before[0], int8_launches() - before[2])
        log(f"  {name}: served 8 test fields at LR {lr.shape[1:4]}; "
            f"launches trunk kernel / conv_int8 {got}, predicted "
            f"{want_launches[name]}; head kernel "
            f"{counters()[4] - before[1]}")
        if got != want_launches[name] or counters()[4] != before[1]:
            fail(f"{name} launched {got}")
        if not np.isfinite(outs[name]).all():
            fail(f"{name} served a non-finite output")
    serve_int8 = int8_launches(each=True)
    log(f"  conv_int8 launches by entry point (head pair, requantizing "
        f"growth conv, conv): {serve_int8}")
    if not all(serve_int8):
        fail(f"an entry point of conv_int8 was not launched: {serve_int8}")
    # the same batch through the plain versions of the entry points on the
    # card: the served int8 outputs do not change by a bit
    with plain_int8_paths():
        for name in INT8_TOL:
            sr.qhead, sr.qtrunk = paths[name]
            before = int8_launches()
            same = np.array_equal(sr.upscale(lr, z), outs[name])
            log(f"  {name}: the kernels' served output equals the plain "
                f"composition's bit for bit: {same}")
            if not same or int8_launches() != before:
                fail(f"{name}: the served int8 output differs from the plain "
                     f"composition's")
    exact = outs["bf16 module head"]
    for name, tol in INT8_TOL.items():
        err = rel_l2(torch.from_numpy(outs[name]), torch.from_numpy(exact))
        log(f"  {name} vs the exact bf16 path: PSNR "
            f"{psnr_db(outs[name], exact):.1f} dB (the JAX package's int8 "
            f"head on a TPU: {JAX_INT8_PSNR_DB} dB)")
        check(f"{name} vs the exact bf16 path", err, tol)
    hcfg = load_config(ini)
    hcfg.use_pallas_head_nograd = True
    sr_h = WindFieldSR(hcfg, sr.G.state_dict(), device=dev)
    lr_d, z_d = (torch.from_numpy(v).to(dev) for v in (lr, z))
    lr32, z32 = (torch.cat([v] * 4) for v in (lr_d, z_d))
    serve_ms = {}
    for n, (lb, zb) in ((8, (lr_d, z_d)), (32, (lr32, z32))):
        reps = 5 if n == 8 else 1
        for name, (h, q) in paths.items():
            sr.qhead, sr.qtrunk = h, q
            serve_ms[(name, n)] = cuda_ms(lambda: sr._generate(lb, zb),
                                          reps=reps)
        serve_ms[("kernel 5", n)] = cuda_ms(lambda: sr_h._generate(lb, zb),
                                            reps=reps)
        log(f"  serving at batch {n}: " + ", ".join(
            f"{name} {serve_ms[(name, n)]:.3f} ms" for name in
            (*paths, "kernel 5")) + f" ({card})")
    with torch.inference_mode():
        for name in INT8_TOL:
            sr.qhead, sr.qtrunk = paths[name]
            kernel_split(f"  {name} serving at batch 8, by kernel",
                         lambda: sr._generate(lr_d, z_d), card,
                         INT8_SPLIT_NAMES)
    # the served backend, back on the exact path: the 6k pack's EMA
    # generator, as --use and --export take it
    sr.dequantize()
    sr6 = sr
    del sr, sr_h, lr32, z32, outs
    torch.cuda.empty_cache()

    # (c) the artifact: run.py --export (phase 8 runs --use on the same
    # weights), eval/server.py --artifact
    art = os.path.join(tmp, "gen.wsrx")
    real_export = run.export_generator
    timing = {}

    def timed_export(*a, **kw):
        t0 = time.monotonic()
        out = real_export(*a, **kw)
        timing["export"] = time.monotonic() - t0
        return out

    run.export_generator = timed_export
    try:
        os.chdir(cwd)
        run.main(["--cfg", ini, "--export", art, "--synthetic", *LEG_DATA])
    finally:
        os.chdir(old)
        run.export_generator = real_export
    header = read_header(art)
    if header["format_version"] != 2 or "norm_stats" not in header:
        fail(f"the artifact's header is {header}")
    # the payload with torch alone, in another process, while this goes on
    check_out = os.path.join(tmp, "torch_only.pt")
    code = (
        "import json, struct, sys, torch\n"
        "from torch.export.passes import move_to_device_pass\n"
        "f = open(sys.argv[1], 'rb')\n"
        "assert f.read(4) == b'WSRX'\n"
        "(n,) = struct.unpack('<I', f.read(4))\n"
        "h = json.loads(f.read(n))\n"
        "dev = sys.argv[3]\n"
        "m = move_to_device_pass(torch.export.load(f), dev).module()\n"
        "g = torch.Generator().manual_seed(2014)\n"
        "lr = torch.randn(2, *h['lr_shape'][1:], generator=g)\n"
        "z = torch.rand(2, *h['z_shape'][1:], generator=g)\n"
        "with torch.inference_mode():\n"
        "    torch.save(m(lr.to(dev), z.to(dev)).cpu(), sys.argv[2])\n"
        "bad = [k for k in sys.modules if k.startswith('gan_sr')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code, art, check_out,
                             str(dev)],
                            cwd=tmp, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        t = time.monotonic()
        server.serve = lambda backend, **kw: kept.update(backend=backend,
                                                         **kw)
        try:
            server.main(["--artifact", art, "--port", "0"])
        finally:
            server.serve = real_serve
        load_s = time.monotonic() - t
        ex = kept.pop("backend")
        log(f"  run.py --export: {os.path.getsize(art)} bytes, "
            f"exported in {timing['export']:.3f} s; eval/server.py "
            f"--artifact built its {type(ex).__name__} backend in "
            f"{load_s:.3f} s (tile {kept['tile']}, overlap "
            f"{kept['tile_overlap']})")
        if not isinstance(ex, ExportedSR) or ex.device.type != dev.type:
            fail("eval/server.py --artifact built no ExportedSR on the card")
        for n in (1, 8):
            reset_counters()
            got = torch.from_numpy(ex.upscale(lr[:n], z[:n]))
            with torch.inference_mode():
                plain = sr6.G(lr_d[:n], z_d[:n]).cpu()
            if counters() != (0, 0, 0, 0, 0) or int8_launches():
                fail(f"the artifact or the plain path launched "
                     f"{counters()}")
            check(f"artifact at batch {n} vs WindFieldSR's plain path",
                  rel_l2(got, plain), EXPORT_PLAIN_TOL)
            check(f"artifact at batch {n} vs the kernel path",
                  rel_l2(got, torch.from_numpy(sr6.upscale(lr[:n], z[:n]))),
                  EXPORT_KERNEL_TOL)
        with torch.inference_mode():
            art_ms = cuda_ms(lambda: ex._module(lr_d, z_d))
            kern_ms = cuda_ms(lambda: sr6._generate(lr_d, z_d))
        log(f"  serving at batch 8: artifact {art_ms:.3f} ms, kernel path "
            f"{kern_ms:.3f} ms ({card})")

        # (d) network interpolation of the two committed packs
        sr9 = WindFieldSR.from_continuation(load_config(ini), PACK_9K,
                                            device=dev)
        p9, p6 = sr9.G.state_dict(), sr6.G.state_dict()
        for alpha, want in ((1.0, p9), (0.0, p6)):
            got = interp.blend_params(p9, p6, alpha)
            same = all(torch.equal(got[k], v) for k, v in want.items())
            log(f"  blend_params(9k, 6k, {alpha}) equals the "
                f"{'9k' if alpha else '6k'} pack's generator tensor by "
                f"tensor: {same}")
            if not same:
                fail(f"alpha {alpha} does not reproduce its pack")
        interp_out, _ = interp_proc.communicate(timeout=TIMEOUT_S * 5)
        interp_s = time.monotonic() - t_interp
        if interp_proc.returncode != 0:
            fail(f"eval.interp failed:\n{interp_out}")
        log(f"  {interp_out.strip().splitlines()[-1]}")
        exb = load_exported(blend, device=dev)
        got = torch.from_numpy(exb.upscale(lr, z))
        mid = WindFieldSR(load_config(ini),
                          interp.blend_params(p9, p6, 0.5), device=dev)
        with torch.inference_mode():
            plain = mid.G(lr_d, z_d).cpu()
        log(f"  eval.interp --alpha 0.5 (another process, beside (b) and "
            f"(c)): {os.path.getsize(blend)} bytes, done {interp_s:.3f} s "
            f"after its start; served 8 fields, finite "
            f"{bool(torch.isfinite(got).all())}")
        if not torch.isfinite(got).all():
            fail("the blended artifact served a non-finite output")
        check("blended artifact vs WindFieldSR's plain path on the blend",
              rel_l2(got, plain), EXPORT_PLAIN_TOL)
        del sr9, mid, exb, p9, p6
        # the torch-only subprocess, against this process on its inputs
        out, _ = proc.communicate(timeout=TIMEOUT_S)
        if proc.returncode != 0:
            fail(f"the torch-only subprocess failed:\n{out}")
        gen = torch.Generator().manual_seed(2014)
        lr2 = torch.randn(2, *header["lr_shape"][1:], generator=gen)
        z2 = torch.rand(2, *header["z_shape"][1:], generator=gen)
        with torch.inference_mode():
            want = ex._module(lr2.to(dev), z2.to(dev)).cpu()
        check("the payload run by torch alone in a subprocess vs "
              "ExportedSR", rel_l2(torch.load(check_out), want),
              EXPORT_PLAIN_TOL)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    del ex, sr6
    torch.cuda.empty_cache()
    return dict(kernels=kernels, launches=serve_int8,
                serve_ms=serve_ms, artifact_ms=art_ms, kernel_path_ms=kern_ms,
                export_s=timing["export"], load_s=load_s,
                artifact_bytes=os.path.getsize(art))


# conv_int8's entry points: (key in check_int8_kernel's results, index in
# int8_launches(each=True))
INT8_ENTRY = {"conv_int8_head_pair": ("pair", 0),
              "conv_int8_requant": ("requant", 1), "conv_int8": ("lff", 2)}


def int8_row(name, dp, replaces, **extra):
    """The kernel line's row of one conv_int8 entry point: its launches in
    phase 10 (b)'s served batches, its check and times at full width."""
    key, i = INT8_ENTRY[name]
    err, ms, plain_ms, bd, lib_ms = dp["kernels"][key]
    return {"name": name, "route": "cuda", "source": f"{CSRC}/conv_int8.cu",
            "replaces": f"gan_sr_wind_field_tpu/ops/{replaces}",
            "replaces_kind": "XLA int8 conv_general_dilated, no Pallas kernel",
            "launches": dp["launches"][i], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bd[0], "bound_by": bd[1],
            "library_ms": lib_ms, "mma": "wgmma s8", **extra}


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
    from gan_sr_wind_field_tpu_torch.ops.kernels import build
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        rrdb_trunk,
        rrdb_trunk_reference,
    )

    # ------------------------------------------------------------ 1. card
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    phase_start(2)
    t = time.monotonic()
    built = build.build()
    for name, (path, secs, report) in built.items():
        log(f"built {name}: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total {time.monotonic() - t:.1f} s")
    # every library's SASS at once (cuobjdump takes seconds each)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(built)) as pool:
        list(pool.map(sass_mma_counts, [v[0] for v in built.values()]))
    log("bf16 kernels on the tensor cores:")
    mma_counts = report_tc_kernels(built)

    # ------------------------------------------- 3. kernels vs plain versions
    phase_start(3)
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
    d_out = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    max_abs16, max_abs_bwd = check_trunk_kernels(rrdbs, x, d_out, geom, nf,
                                                 gc, nconv, dev)
    err_grad, err_adj = check_stencil_kernels(dev)
    hr_xy = lr_xy * cfg.scale
    tc = g.terrain_number_of_features
    head_dims = (hr_xy, zl, nf, tc, nf + tc, g.hr_kern_size)
    err_head = check_head_kernel(dev, *head_dims)
    check_head_bf16(dev, *head_inputs(dev, 32, *head_dims, 2005),
                    head_dims[-1], "batch 32")
    torch.cuda.synchronize()
    del rrdbs, x, d_out

    # ------------------------------------------------------------ 4. serve
    phase_start(4)
    G0 = generator_from_config(cfg, device=dev, seed=2001)
    params = G0.state_dict()
    sr = WindFieldSR(cfg, params, device=dev)
    del G0
    if sr.packed is None:
        fail("milestone9k geometry does not take the trunk kernel")
    if sr.head_packed is not None:
        fail("milestone9k as committed takes the head kernel in serving")
    rng = np.random.default_rng(2001)
    C = cfg.lr_num_channels

    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    outs = []
    reset_counters()
    srv = serve(sr, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=20.0)
    pool = ThreadPoolExecutor(max_workers=6)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/upscale"
        for n in (None, None, None, None, 8):
            lr, z = sample(rng, 1 if n is None else n, lr_xy, hr_xy, zl, C)
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
        lr, z = sample(rng, 6, lr_xy, hr_xy, zl, C)
        futs = [pool.submit(srv.batcher.submit, lr[i], z[i], TIMEOUT_S)
                for i in range(6)]
        outs.extend(f.result(timeout=TIMEOUT_S + 30) for f in futs)
        stats = srv.batcher.stats_snapshot()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        srv.close()
    serve_launches, head_launches = counters()[0], counters()[4]
    log(f"served {len(outs)} samples in {stats['batches']} batches "
        f"(max batch {stats['max_batch_seen']}, errors {stats['errors']}); "
        f"trunk kernel launches {serve_launches}, head kernel launches "
        f"{head_launches}")
    if head_launches:
        fail("milestone9k as committed launched the head kernel in serving")
    for o in outs:
        if o.shape != (hr_xy, hr_xy, zl, 3) or not np.isfinite(o).all():
            fail(f"bad output: shape {o.shape}, "
                 f"finite {bool(np.isfinite(o).all())}")
    if len(outs) != 18 or serve_launches < 1 or stats["errors"]:
        fail(f"{len(outs)} outputs, {serve_launches} kernel launches, "
             f"{stats['errors']} batch errors")

    lr, z = sample(rng, 8, lr_xy, hr_xy, zl, C)
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

    # the head path: a copy of milestone9k with use_pallas_head_nograd, the
    # same weights, one batch of 8 against the module head
    hcfg = copy.deepcopy(cfg)
    hcfg.use_pallas_head_nograd = True
    sr_h = WindFieldSR(hcfg, params, device=dev)
    if sr_h.head_packed is None:
        fail("use_pallas_head_nograd does not route serving through the head")
    lr, z = sample(np.random.default_rng(2002), 8, lr_xy, hr_xy, zl, C)
    reset_counters()
    got = sr_h.upscale(lr, z)
    head_serve = counters()
    log(f"head path: served 8 samples; launches {LAUNCH_LABELS} "
        f"{head_serve}")
    if head_serve != (1, 0, 0, 0, 1):
        fail(f"the head path's serving launched {head_serve}")
    if got.shape != (8, hr_xy, hr_xy, zl, 3) or not np.isfinite(got).all():
        fail(f"bad head-path output: shape {got.shape}")
    err_head_srv = rel_l2(torch.from_numpy(got),
                          torch.from_numpy(sr.upscale(lr, z)))
    check("served output, head kernel vs module head", err_head_srv, 3e-2)

    # ------------------------------------------------------------ 5. train
    phase_start(5)
    gan, state, batch, train_launches = train_phase(
        copy.deepcopy(cfg), dev, rng, card)
    gan_h, state_h, head_train = head_train_phase(cfg, gan, state, batch,
                                                  dev, card)

    # ------------------------------------------------------------ 6. times
    phase_start(6)
    xb = torch.randn(8, lr_xy, lr_xy, zl, nf, generator=gen).to(
        dev, torch.bfloat16)
    kw = dict(geom)
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
        turns = alternate(lambda: rrdb_trunk(sr.packed, xb, **kw),
                          lambda: cudnn_trunk(lib_w, xb))
        fwd_ms = cuda_ms(lambda: sr._generate(lr_d, z_d))
    log_turns("trunk kernel at batch 8 vs its bf16 cuDNN chain", turns, card)
    ms, lib_ms = turns[:2]
    with torch.inference_mode():
        kernel_split("trunk kernel at batch 8, by kernel",
                     lambda: rrdb_trunk(sr.packed, xb, **kw), card)
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
    # input and output once, the bf16 weights once
    nbytes = 2 * (2 * xb.numel()
                  + sum(t.numel() for t in sr.packed.values()))
    b1 = bound(2 * trunk_macs(rows, J, nf, gc, K), nbytes, H100_BF16_FLOPS)
    del lib_w
    log(f"trunk bound at batch 8: {b1[0]:.4f} ms by {b1[1]} (ops "
        f"{b1[2]:.4f} ms, bytes {b1[3]:.4f} ms); the kernel at "
        f"{100 * b1[0] / ms:.2f} % of it, "
        f"{H100_BF16_FLOPS * b1[2] / ms / 1e12:.1f} TFLOP/s")
    tt = time_training(gan, state, batch, geom, nf, gc, nconv, dev, card)
    th = time_head(sr, sr_h, gan_h, state_h, batch, lr_d, z_d, head_dims,
                   dev, card)
    del sr, sr_h
    if not all(math.isfinite(v) for v in (ms, plain_ms, lib_ms, fwd_ms)):
        fail("a timing is not finite")

    # ------------------------------------------------------------- 7. loop
    phase_start(7)
    del gan, state, gan_h, state_h, batch
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="windsr_leg_")
    try:
        ll, state, ckpt_path, leg_ms = loop_phase(dev, card, tt, tmp)
        # ------------------------------------------------- 8. test, use, serve
        phase_start(8)
        ev = eval_phase(dev, card, tmp, state, ckpt_path)
        del state
        torch.cuda.empty_cache()
        # --------------------------------- 9. chunks, host path, tiled SR
        phase_start(9)
        ch = chunk_phase(dev, card, tmp, leg_ms, ev.pop("field"))
        # ------------------------ 10. int8 serving, export, interpolation
        phase_start(10)
        dp = deploy_phase(dev, card, tmp, built)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row(name, src, replaces, launches, err, t, lib, **extra):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
                "replaces": f"{TPU}/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": lib,
                **extra}

    tl = train_launches
    # phase 9's launches: the chunked leg (replays counted), the host data
    # path leg and the tiled SR
    cl = tuple(a + b + c for a, b, c in zip(ch["chunk"], ch["host"],
                                            ch["tiled"]))
    table = {"kernels": [
        row("rrdb_trunk", "rdb_trunk.cu", "rdb_trunk.py:178",
            serve_launches + tl[0] + ll[0] + ev["trunk"] + cl[0], max_abs16,
            (ms, plain_ms, b1), lib_ms, launches_serve=serve_launches,
            launches_train=tl[0], launches_loop=ll[0],
            launches_test=ev["trunk"], launches_chunks=ch["chunk"][0],
            launches_host_path=ch["host"][0], launches_tiled=ch["tiled"][0],
            generate_field_ms=ev["ms_module_head"],
            tiled_512_ms=ch["tiled_ms"],
            residual_ms=tt["k1r"][0], residual_plain_ms=tt["k1r"][1],
            residual_bound_ms=tt["k1r"][2][0],
            residual_library_ms=tt["k1r_lib"], mma=TC_MMA["rdb_trunk"],
            sass_mma_count=mma_counts["rdb_trunk"]),
        row("rrdb_trunk_bwd", "rdb_trunk_bwd.cu", "rdb_trunk.py:429",
            tl[1] + ll[1] + cl[1], max_abs_bwd, tt["k2"][:3], tt["k2"][3],
            launches_train=tl[1], launches_loop=ll[1],
            launches_chunks=ch["chunk"][1], launches_host_path=ch["host"][1],
            mma=TC_MMA["rdb_trunk_bwd"],
            sass_mma_count=mma_counts["rdb_trunk_bwd"]),
        *(row(name, "stencil.cu", replaces, tl[i] + ll[i] + cl[i], err,
              (k["ms"], k["plain_ms"], k["bound"]), None,
              launches_train=tl[i], launches_loop=ll[i],
              launches_chunks=ch["chunk"][i],
              launches_host_path=ch["host"][i],
              device_ms=k["device_ms"], device_ms_cold=k["device_ms_cold"])
          for name, replaces, i, err, k in (
              ("wind_gradient", "stencil.py:78", 2, err_grad, tt["k3"]),
              ("wind_gradient_adjoint", "stencil.py:166", 3, err_adj,
               tt["k4"]))),
        row("hr_head", "hr_head.cu", "hr_head.py:122",
            head_serve[4] + head_train[4] + ll[4] + ev["head"] + cl[4],
            err_head, th[8][:3], th[8][3], launches_serve=head_serve[4],
            launches_train=head_train[4], launches_loop=ll[4],
            launches_test=ev["head"], launches_tiled=ch["tiled"][4],
            generate_field_ms=ev["ms_head_kernel"],
            tiled_512_ms=ch["tiled_head_ms"],
            ms_b32=th[32][0], plain_ms_b32=th[32][1],
            bound_ms_b32=th[32][2][0], library_ms_b32=th[32][3],
            library_ms_benchmark_off=th[8][4],
            library_ms_benchmark_on=th[8][5],
            library_ms_b32_benchmark_off=th[32][4],
            library_ms_b32_benchmark_on=th[32][5],
            backward_library_ms_b32=th["vjp"], mma=TC_MMA["hr_head"],
            sass_mma_count=mma_counts["hr_head"]),
        # the port's own kernels: the JAX package's int8 convs are XLA
        *(int8_row(name, dp, replaces, **extra) for name, replaces, extra in (
            ("conv_int8_head_pair", "quant.py:87", dict(
                library="bf16 cuDNN hr_conv0_x, the conv the pair replaces",
                ms_b32=dp["kernels"]["pair_b32"][0],
                plain_ms_b32=dp["kernels"]["pair_b32"][1],
                bound_ms_b32=dp["kernels"]["pair_b32"][2][0],
                library_ms_b32=dp["kernels"]["pair_b32"][3],
                kernel5_ms=dp["kernels"]["k5"],
                kernel5_ms_b32=dp["kernels"]["pair_b32"][4],
                serving_ms={f"{name} b{n}": ms for (name, n), ms
                            in dp["serve_ms"].items()},
                artifact_ms=dp["artifact_ms"],
                kernel_path_ms=dp["kernel_path_ms"])),
            ("conv_int8_requant", "quant_trunk.py:78", {}),
            ("conv_int8", "quant_trunk.py:78", dict(
                library="torch._int_mm (cuBLASLt int8 GEMM, int32 out) on "
                        "the LFF's operands")))),
    ]}
    log(f"total {time.monotonic() - T0:.1f} s")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--stencils-of":
        stencils_of(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--stencils-of ROOT]")
    else:
        main()
