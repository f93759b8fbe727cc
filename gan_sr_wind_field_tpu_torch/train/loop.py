"""Training loop of the port.

Counterpart of ``gan_sr_wind_field_tpu/train/loop.py:train`` and
``run_validation``:

- the hot loop takes the next batch and runs ``WindFieldGAN.train_step``;
  the G/D alternation and the schedules live in the step. With
  ``device_resident_data`` and ``steps_per_dispatch`` K > 1 it runs chunks
  of K steps through ``WindFieldGAN.train_chunk`` (CUDA graphs of the step
  on the card); a chunk never crosses a log, validation or save boundary,
  ``niter`` or the end of the profiler window, and single steps fill the
  remainders. A chunk's steps train on the batches the per-step loop would
  draw for their iterations, so the two loops give the same state;
- with ``device_resident_data`` the training split is uploaded to the card
  once and batches are cut there (``data/device_data.py``), else a thread
  copies host batches to the device (``data/pipeline.py``); augmentation
  then runs on the card inside the step, and the dataset's own is off;
- logging, validation and checkpoints run at their periods; SIGTERM
  checkpoints and exits cleanly (at the next chunk end), and the stall
  watchdog turns a hang into that SIGTERM;
- with ``profile_dir`` a ``torch.profiler`` window records the host (and
  the card) from the first iteration to the first boundary at or after
  ten iterations, and writes a trace that Chrome and Perfetto read
  (``profile_it{start}-{end}.pt.trace.json``) into ``profile_dir``;
- warm start: a found resume checkpoint wins; else a ``.npz``
  continuation pack loads G, D, D's statistics, the EMA and ``it`` with
  the Adam moments at zero, a reference ``G_{it}.pth`` loads G (the EMA
  seeded from it) and, beside it or alone, a reference ``D_{it}.pth``
  loads D and its statistics, and a port checkpoint loads weights only.

Where a save and a validation fall on one iteration, the port validates
first: validation moves D's running statistics (as the reference does), so
the checkpoint then holds the state that training goes on from, and a resume
from it is bit-exact. The JAX package saves first.
"""

from __future__ import annotations

import logging
import os
import pickle
import signal
import time
from typing import Optional

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher
from gan_sr_wind_field_tpu_torch.data.pipeline import prefetch_to_device
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import GANTrainState, WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.watchdog import StallWatchdog
from gan_sr_wind_field_tpu_torch.utils.progress import DisplayBar
from gan_sr_wind_field_tpu_torch.utils.tb import MetricsWriter
from gan_sr_wind_field_tpu_torch.utils.torch_import import (
    load_reference_checkpoint,
    load_reference_discriminator,
)

TRAIN_LOSS_KEYS = (
    "total", "adversarial", "pix", "xy_gradient", "z_gradient",
    "divergence", "xy_divergence", "feature_D",
)


def _load_weights(cfg, gan: WindFieldGAN, state: GANTrainState,
                  run_folder: str, status):
    """The warm-start branches of ``loop.py:104-221`` of the JAX package."""
    resume_path = None
    if cfg.training.resume_training_from_save:
        resume_path = (cfg.env.state_load_path
                       or ckpt.latest_checkpoint(run_folder))
    if resume_path:
        state = ckpt.restore_checkpoint(resume_path, state)
        status.info(f"resumed from {resume_path} at it={state.it}")
        return state
    g_path = cfg.env.generator_load_path
    d_path = cfg.env.discriminator_load_path
    g_is_pth = bool(g_path) and g_path.endswith(".pth")
    d_is_pth = bool(d_path) and d_path.endswith(".pth")
    if g_path and g_path.endswith(".npz"):
        state = ckpt.load_pack(state, g_path)
        status.info(f"continuation warm start from {g_path} at "
                    f"it={state.it} (optimizer moments reset)")
    elif g_is_pth:
        params_G, _, _ = load_reference_checkpoint(gan.G, g_path)
        state.params_G = ckpt.replace_tree(state.params_G, params_G, "G")
        if state.params_G_ema is not None:
            # seeded from the imported weights: left at the random init the
            # EMA would anneal from noise for ~1/(1 - decay) iterations
            state.params_G_ema = {k: v.clone()
                                  for k, v in state.params_G.items()}
        status.info(f"imported reference weights G={g_path}")
    elif g_path:
        # weights only from a port checkpoint; the training state is fresh
        loaded = ckpt.restore_checkpoint(g_path, state, restore_rng=False)
        state.params_G = loaded.params_G
        state.params_D = loaded.params_D
        state.batch_stats_D = loaded.batch_stats_D
        state.params_D_frozen = loaded.params_D_frozen
        if state.params_G_ema is not None:
            state.params_G_ema = loaded.params_G_ema
        status.info(f"loaded weights (fresh training state) from {g_path}")
    if d_is_pth:
        # beside any G source, as the reference's load_model reads D
        params_D, stats_D = load_reference_discriminator(gan.D, d_path)
        state.params_D = ckpt.replace_tree(state.params_D, params_D, "D")
        state.batch_stats_D = ckpt.replace_tree(state.batch_stats_D, stats_D,
                                                "D's statistics")
        status.info(f"imported reference weights D={d_path}")
    return state


def train(cfg, dataset_train, dataset_validation, x, y,
          max_steps: Optional[int] = None, device=None,
          profile_dir: Optional[str] = None) -> GANTrainState:
    """Run training to ``cfg.training.niter`` (at most ``max_steps``, an
    absolute iteration) on ``device`` (the card unless the caller asks for
    the CPU); with ``profile_dir``, trace the first iterations into it.
    Returns the final state."""
    device = resolve_device(device)
    status = logging.getLogger("status")
    cfg_t = cfg.training
    run_folder = cfg.env.this_runs_folder or "./runs_root/run"
    os.makedirs(os.path.join(run_folder, "images"), exist_ok=True)
    tb = MetricsWriter(
        cfg.env.this_runs_tensorboard_log_folder
        or os.path.join(run_folder, "tb"),
        use_tensorboard=cfg.use_tensorboard_logger,
    )
    gan = WindFieldGAN(cfg, x, y, device=device)

    # consolidate the pickle cache into one float32 memmap (data/npcache.py)
    try:
        dataset_train.use_npcache()
    except Exception as e:  # fall back to per-sample pickles
        status.info(f"npcache unavailable ({e}); using pickle loads")

    # augmentation moves into the step, on the device
    augment_on_device = bool(
        dataset_train.data_aug_rot or dataset_train.data_aug_flip
    )
    dataset_train.data_aug_rot = False
    dataset_train.data_aug_flip = False

    batch_size = cfg.dataset_train.batch_size if cfg.dataset_train else 1
    rng_np = np.random.default_rng(cfg.env.fixed_seed)
    if batch_size > len(dataset_train):
        raise ValueError(
            f"batch_size {batch_size} exceeds the train split "
            f"({len(dataset_train)} samples) — with drop_remainder the "
            f"loop would produce zero batches"
        )
    probe_lr, probe_hr, _ = dataset_train.get(0, rng_np)
    state = gan.init_state(
        cfg.env.fixed_seed,
        (batch_size,) + probe_lr.shape,
        (batch_size,) + probe_hr.shape,
    )
    if cfg.load_model_from_save:
        state = _load_weights(cfg, gan, state, run_folder, status)

    niter = min(cfg_t.niter, max_steps) if max_steps else cfg_t.niter
    start_it = state.it
    status.info(f"beginning run at it={start_it}, target niter={niter}")

    it = start_it
    voxels_per_batch = batch_size * int(np.prod(probe_hr.shape[:3]))
    t_window, it_window = time.time(), it
    batches_per_epoch = max(len(dataset_train) // batch_size, 1)
    epochs = max(
        1, int(np.ceil((niter - start_it) / batches_per_epoch)) + 1
    )
    if cfg.device_resident_data:
        batches = DeviceBatcher(
            dataset_train, batch_size, device,
            seed=int(rng_np.integers(0, 2**31 - 1)),
            # continue the batch stream across resume legs (the seed comes
            # from fixed_seed the same way on every start)
            start_count=start_it,
        )
        status.info(
            "device-resident training data: "
            f"{batches.resident_bytes() / 1e6:.0f} MB uploaded once"
        )
    else:
        batches = prefetch_to_device(
            dataset_train.batches(batch_size, rng_np, shuffle=True,
                                  epochs=epochs),
            device,
        )

    bar = None
    if cfg.display_bar:
        bar = DisplayBar(max_value=batches_per_epoch, start_it=it,
                         niter=niter)

    profiler = None
    if profile_dir:
        profiler = torch.profiler.profile(activities=(
            [torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA]
               if device.type == "cuda" else [])))
        profiler.start()

    def stop_profile():
        nonlocal profiler
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"profile_it{start_it}-{it}.pt.trace.json")
        profiler.export_chrome_trace(path)
        profiler = None
        status.info(f"profile of it {start_it} -> {it} written to {path}")

    # graceful preemption: finish the step in flight, checkpoint, exit
    stop_signal = []
    old_handler = None
    try:
        old_handler = signal.signal(signal.SIGTERM,
                                    lambda signum, frame:
                                    stop_signal.append(signum))
    except ValueError:  # not the main thread
        pass

    watchdog = None
    if cfg_t.stall_watchdog_s and old_handler is not None:
        watchdog = StallWatchdog(
            cfg_t.stall_watchdog_s,
            startup_deadline_s=max(6 * cfg_t.stall_watchdog_s, 1800),
        ).start()
        status.info(
            "stall watchdog armed at first step: "
            f"{cfg_t.stall_watchdog_s:.0f}s (startup deadline "
            f"{watchdog.startup_deadline_s:.0f}s)"
        )

    saved_at = None

    def save():
        nonlocal saved_at
        if watchdog is not None:
            watchdog.grace(max(2 * cfg_t.stall_watchdog_s, 600))
        path = ckpt.save_checkpoint(run_folder, state,
                                    keep_last=cfg_t.keep_checkpoints)
        saved_at = state.it
        status.info(f"saved checkpoint {path}")
        if watchdog is not None:
            watchdog.beat()

    def boundary_work(metrics):
        nonlocal state, t_window, it_window
        if watchdog is not None:
            watchdog.beat()
        if profiler is not None and it - start_it >= 10:
            stop_profile()
        if it % cfg_t.log_period == 0:
            host_m = {k: float(metrics[k]) for k in TRAIN_LOSS_KEYS}
            dt = time.time() - t_window
            ips = (it - it_window) / max(dt, 1e-9)
            t_window, it_window = time.time(), it
            status.info(
                f"it {it} G_total {host_m['total']:.5f} "
                f"D {float(metrics['D_train_loss']):.5f} "
                f"{ips:.2f} it/s ({ips * voxels_per_batch / 1e6:.2f} Mvox/s)"
            )
            tb.add_scalars("G_loss/train", host_m, it)
            if "G_grad_norm" in metrics and float(metrics["is_g_step"]) > 0:
                tb.add_scalars(
                    "metrics/grad",
                    {"G_grad_norm": float(metrics["G_grad_norm"])}, it,
                )
            tb.add_scalars(
                "perf", {"it_per_s": ips,
                         "voxels_per_s": ips * voxels_per_batch}, it,
            )
        if dataset_validation is not None and it % cfg_t.val_period == 0:
            if watchdog is not None:
                watchdog.grace(max(6 * cfg_t.stall_watchdog_s, 1800))
            state = run_validation(cfg, gan, state, dataset_validation, tb,
                                   run_folder, it)
            if watchdog is not None:
                watchdog.beat()
        if it % cfg_t.save_model_period == 0:
            save()

    chunk_steps = int(getattr(cfg, "steps_per_dispatch", 1) or 1)
    chunked = chunk_steps > 1 and cfg.device_resident_data
    if chunk_steps > 1 and not chunked:
        status.warning(f"steps_per_dispatch = {chunk_steps} needs "
                       "device_resident_data: stepping one iteration at a "
                       "time")
    periods = [cfg_t.log_period, cfg_t.save_model_period]
    if dataset_validation is not None:
        periods.append(cfg_t.val_period)
    periods = [p for p in periods if p and p > 0]

    def next_boundary(i):
        cands = [((i // p) + 1) * p for p in periods] + [niter]
        if profiler is not None:
            cands.append(start_it + 10)
        return min(c for c in cands if c > i)

    try:
        while it < niter and not stop_signal:
            if chunked and next_boundary(it) - it >= chunk_steps:
                state, metrics = gan.train_chunk(
                    state, batches.full, batches.zraw, batches.seed,
                    n_steps=chunk_steps, augment=augment_on_device,
                    **batches.slice_kwargs())
                it += chunk_steps
            else:
                if cfg.device_resident_data:
                    batches.count = it  # the batch of iteration it + 1
                batch = next(batches, None)
                if batch is None:
                    break
                it += 1
                state, metrics = gan.train_step(state, *batch,
                                                augment=augment_on_device)
            if bar is not None:
                bar.update(it % batches_per_epoch,
                           it * batch_size // len(dataset_train), it)
            boundary_work(metrics)
    finally:
        if not cfg.device_resident_data:
            batches.close()

    if stop_signal:
        status.warning(f"SIGTERM at it {it}: checkpointing and exiting "
                       "cleanly")
    elif it < niter:
        status.warning(
            f"batch iterator exhausted at it {it} < niter {niter} — "
            "training ended early"
        )
    if profiler is not None:  # the loop ended inside the window
        stop_profile()
    if state.it != start_it and saved_at != state.it:
        # the watchdog stays armed through the final save: a save that
        # hangs still ends in its hard exit
        save()
    if watchdog is not None:
        watchdog.stop()
    if old_handler is not None:
        # restored only after the final save: a watchdog SIGTERM during a
        # hung save must reach the loop's handler, not the default one
        signal.signal(signal.SIGTERM, old_handler)
    tb.close()
    return state


def val_seed(fixed_seed: int, it: int, batch_index: int) -> int:
    """The seed of validation batch ``batch_index`` at iteration ``it``:
    validation draws (D's dropout, instance noise) from its own generator
    and leaves the state's untouched."""
    return int(np.random.SeedSequence([fixed_seed, it, batch_index])
               .generate_state(1, np.uint64)[0])


def run_validation(cfg, gan: WindFieldGAN, state: GANTrainState,
                   dataset_validation, tb, run_folder: str, it: int):
    """Full validation sweep: averaged losses and metrics to the writer and
    the status log, one sample's fields to
    ``images/val_imgs__it_{it}.pkl``, and, with ``use_tensorboard_logger``
    and a writer that has a figure sink, that sample's comparison and
    error figures of the u component (``viz/plots.py``), as JAX
    ``train/loop.py:555-569`` adds them."""
    status = logging.getLogger("status")
    # deterministic track: the same patch offsets every sweep
    deterministic = bool(cfg.dataset_val and cfg.dataset_val.deterministic)
    rng_np = np.random.default_rng(
        cfg.env.fixed_seed if deterministic else cfg.env.fixed_seed + it
    )
    batch_size = cfg.dataset_val.batch_size if cfg.dataset_val else 1

    sums, count = {}, 0
    last_batch = None
    for bi, (lr_b, hr_b, z_b) in enumerate(
        dataset_validation.batches(batch_size, rng_np, shuffle=False,
                                   drop_remainder=False)
    ):
        gen = torch.Generator(device=gan.device).manual_seed(
            val_seed(cfg.env.fixed_seed, it, bi))
        # the reference's D forwards in train mode move D's running
        # statistics; val_step writes them into the state
        metrics, _ = gan.val_step(state, lr_b, hr_b, z_b, generator=gen)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
        last_batch = (lr_b, hr_b, z_b)

    if count == 0:
        return state
    avgs = {k: v / count for k, v in sums.items()}
    tb.add_scalars(
        "G_loss/validation",
        {k.replace("G_val_", ""): v for k, v in avgs.items()
         if k.startswith("G_val_")},
        it,
    )
    tb.add_scalars("D_loss/", {"validation_loss": avgs["D_val_loss"]}, it)
    tb.add_scalars(
        "metrics/PSNR",
        {k: v for k, v in avgs.items() if "PSNR" in k}, it,
    )
    tb.add_scalars(
        "metrics/pix",
        {k: v for k, v in avgs.items() if "pix" in k}, it,
    )
    status.info(
        f"validation it {it}: PSNR {avgs['val_PSNR']:.3f} "
        f"(trilinear {avgs['Trilinear_PSNR']:.3f}) "
        f"G_total {avgs['G_val_total']:.5f}"
    )

    # one random sample's fields (reference train.py:205-336)
    lr_b, hr_b, z_b = last_batch
    uvw_max = dataset_validation.stats.uvw_max
    i = int(np.random.default_rng(it).integers(0, lr_b.shape[0]))
    sr = gan.generate(state, lr_b[i:i + 1], z_b[i:i + 1])[0].cpu().numpy()
    lr_i = torch.from_numpy(np.ascontiguousarray(lr_b[i:i + 1, ..., :3]))
    tl = upsample_trilinear_xy(lr_i, cfg.scale)[0].numpy()
    imgs = {
        "HR": np.moveaxis(hr_b[i] * uvw_max, -1, 0),
        "SR": np.moveaxis(sr * uvw_max, -1, 0),
        "BC": np.moveaxis(tl * uvw_max, -1, 0),
        "LR": np.moveaxis(lr_b[i, ..., :3] * uvw_max, -1, 0),
    }
    with open(os.path.join(run_folder, "images", f"val_imgs__it_{it}.pkl"),
              "wb") as f:
        pickle.dump(imgs, f)

    if cfg.use_tensorboard_logger and tb.has_figure_sink:
        from gan_sr_wind_field_tpu_torch.viz.plots import (
            create_comparison_figure,
            create_error_figure,
        )

        z_idx = min(3, hr_b.shape[3] - 1)
        hr_c, sr_c, tl_c, lr_c = (imgs[k][0] for k in ("HR", "SR", "BC",
                                                       "LR"))
        sr_err = float(np.mean(np.abs(hr_c[:, :, z_idx] - sr_c[:, :, z_idx])))
        tl_err = float(np.mean(np.abs(hr_c[:, :, z_idx] - tl_c[:, :, z_idx])))
        tb.add_figure(
            f"im/{it}/wind_fields/u_field_z_index{z_idx}",
            create_comparison_figure(z_idx, lr_c, hr_c, sr_c, tl_c), it)
        tb.add_figure(
            f"im/{it}/Error/u_field_z_index{z_idx}",
            create_error_figure(z_idx, hr_c, sr_c, tl_c, sr_err, tl_err), it)
    return state
