"""Command line of the port: ``python -m gan_sr_wind_field_tpu_torch.run``.

Counterpart of the root ``run.py``: argv → ``Config``, the run folders,
the config snapshot and the loggers, the data (``--synthetic``: analytic
fields; without it the hourly cache of the config's dates, filled from the
HARMONIE-SIMRA raw files when it is empty), then one of

- ``--download``: the config's dates from the raw files under
  ``<data_root>/downloaded_raw_bessaker_data/`` into the hourly cache
  (``data/downloader.py``), fetching only the files absent there; alone it
  ends there and needs no card, beside another mode it goes on to it;
- ``--train [--profile]``: the training loop (``train/loop.py``), with
  ``--profile`` a ``torch.profiler`` trace of its first iterations in the
  run's TensorBoard log folder;
- ``--test [--test_ema]``: the held-out test chain (``eval/test_loop.py``);
- ``--use [--no_ema]``: the SR field dumps of the test split;
- ``--serve PORT [--serve_warmup B1,B2] [--serve_strict_shapes]
  [--no_ema] [--serve_int8 N] [--serve_int8_trunk N]``: the
  micro-batching HTTP server (``eval/server.py``), with ``--serve_int8``
  / ``--serve_int8_trunk`` the int8 serving head / trunk calibrated on N
  test fields first;
- ``--export PATH [--no_ema]``: the ``torch.export`` serving artifact
  (``eval/export.py``), alone or beside ``--use`` and ``--serve``;
- ``--param_search [--num_samples N] [--asha_grace IT] [--asha_eta ETA]
  [--slurm_array_id K]``: the physics-weight search (``search/``), shard
  ``K % N_SHARDS`` of ``N_SHARDS`` (an environment variable, default 1).

::

    python -m gan_sr_wind_field_tpu_torch.run --download \\
        --cfg configs/milestone9k.ini
    python -m gan_sr_wind_field_tpu_torch.run --train \\
        --cfg configs/milestone9k.ini
    python -m gan_sr_wind_field_tpu_torch.run --train --synthetic \\
        --synthetic_hours 240 --synthetic_size 128 \\
        --cfg configs/milestone9k.ini
    python -m gan_sr_wind_field_tpu_torch.run --test --synthetic \\
        --synthetic_hours 240 --synthetic_size 128 --cfg <config.ini>

``--test``, ``--use``, ``--serve`` and ``--export`` take their weights from
``env.generator_load_path``: a continuation pack (``.npz``), a port
checkpoint folder (``ckpt_{it}``) or a reference ``G_{it}.pth``; a
training run warm-starts from the same (and from a reference
``D_{it}.pth`` in ``env.discriminator_load_path``) under
``load_model_from_save``. Each mode runs on the card; ``--device cpu``
runs the plain PyTorch path on the CPU instead, and without either a card
or that flag it raises.

``--train`` reads ``[PARALLEL]``: under ``torchrun`` it trains on a mesh
of ``data_parallel`` rows (-1: every rank the model and spatial axes
leave) × ``tensor_parallel`` shares of G's output channels ×
``spatial_parallel`` x slabs (``parallel/mesh.py``), one card each
(``cuda:LOCAL_RANK``; with ``--device cpu`` CPU processes over gloo), and
shrinks the data axis to the largest divisor of the batch, as the JAX
package does; ranks past the mesh are idle; with ``--download`` the first
rank fills the cache before the others read it. A mesh larger than the
ranks started raises ``ValueError``. The other modes run in one process,
as in the JAX package, and raise under ``torchrun`` with more than one
rank::

    torchrun --standalone --nproc_per_node=8 \
        -m gan_sr_wind_field_tpu_torch.run --train --synthetic \
        --cfg configs/milestone9k.ini
    # whole 128x128x10 volumes on data 2 x spatial 4
    torchrun --standalone --nproc_per_node=8 \
        -m gan_sr_wind_field_tpu_torch.run --train --synthetic \
        --cfg configs/fullvol.ini
    # [PARALLEL] tensor_parallel = 2 in a copy of the config: data 4 x
    # model 2, G's output channels over the model axis
    torchrun --standalone --nproc_per_node=8 \
        -m gan_sr_wind_field_tpu_torch.run --train --synthetic \
        --cfg my_tp2.ini
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from datetime import date

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.config import Config
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.data.downloader import download_dataset
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.eval.export import export_generator
from gan_sr_wind_field_tpu_torch.eval.test_loop import run_test, run_use
from gan_sr_wind_field_tpu_torch.parallel.mesh import (
    data_axis,
    init_distributed,
    make_mesh,
    world_size_from_env,
)
from gan_sr_wind_field_tpu_torch.search.driver import param_search
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.loop import train
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers


def argv_to_cfg(argv=None):
    p = argparse.ArgumentParser(
        description="wind-field super-resolution GAN, PyTorch port")
    p.add_argument("--cfg", default="configs/local.ini",
                   help="config INI path")
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_ema", action="store_true",
                   help="with --test: evaluate the checkpoint's EMA "
                        "generator slot instead of the raw generator; "
                        "outputs get an _ema suffix")
    p.add_argument("--use", action="store_true")
    p.add_argument("--download", action="store_true",
                   help="fill the hourly cache of the config's dates from "
                        "the HARMONIE-SIMRA raw files, fetching those "
                        "absent; with another mode, go on to it")
    p.add_argument("--no_ema", action="store_true",
                   help="with --use/--serve: deploy the raw generator "
                        "weights even when the checkpoint has an EMA slot "
                        "(default prefers EMA)")
    p.add_argument("--serve", metavar="PORT", type=int, default=None,
                   help="serve the generator over HTTP on PORT "
                        "(micro-batched, eval/server.py)")
    p.add_argument("--serve_warmup", metavar="B1,B2,...", default="",
                   help="with --serve: run the forward at these batch "
                        "sizes before accepting traffic")
    p.add_argument("--serve_strict_shapes", action="store_true",
                   help="with --serve: reject /v1/upscale requests whose "
                        "LR sample shape differs from the training patch; "
                        "other extents go through /v1/upscale_tiled")
    p.add_argument("--serve_int8", metavar="N", type=int, default=0,
                   help="with --serve: calibrate the int8 HR-head serving "
                        "path over N test samples before serving "
                        "(ops/quant.py; needs the trunk-kernel path)")
    p.add_argument("--serve_int8_trunk", metavar="N", type=int, default=0,
                   help="with --serve: calibrate the int8 trunk serving "
                        "path over N test samples (ops/quant_trunk.py)")
    p.add_argument("--export", metavar="PATH", default=None,
                   help="write the generator as a self-contained "
                        "torch.export artifact at PATH (eval/export.py); "
                        "loads weights like --use")
    p.add_argument("--synthetic", action="store_true",
                   help="use analytic synthetic data instead of the "
                        "HARMONIE-SIMRA cache")
    p.add_argument("--synthetic_hours", type=int, default=48,
                   help="number of hourly synthetic samples to generate")
    p.add_argument("--synthetic_size", type=int, default=64,
                   help="horizontal extent of the synthetic domain; larger "
                        "than slice_size gives true random-patch training")
    p.add_argument("--param_search", action="store_true",
                   help="search the physics-loss weights under ASHA "
                        "(search/driver.py)")
    p.add_argument("--num_samples", type=int, default=250,
                   help="--param_search trial budget (reference "
                        "param_search.py:386)")
    p.add_argument("--asha_grace", type=int, default=1200,
                   help="--param_search ASHA grace period in iterations "
                        "(reference param_search.py:300)")
    p.add_argument("--asha_eta", type=int, default=3,
                   help="--param_search ASHA reduction factor")
    p.add_argument("--slurm_array_id", type=int, default=1,
                   help="--param_search shard: this driver runs the "
                        "trials i with i %% N_SHARDS == id %% N_SHARDS")
    p.add_argument("--profile", action="store_true",
                   help="with --train: trace the first iterations with "
                        "torch.profiler into the TensorBoard log folder")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop at this iteration (absolute, like niter)")
    p.add_argument("--loglevel", default="info")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, 'cpu' only "
                        "when asked")
    args = p.parse_args(argv)
    if not (args.download or _runs_a_model(args)):
        p.error("nothing to do: pass --train, --test, --use, --export, "
                "--serve, --param_search or --download")

    cfg = Config.from_ini(args.cfg)
    cfg.is_train = args.train or args.param_search
    cfg.is_test = args.test
    cfg.is_use = args.use
    cfg.is_download = args.download
    cfg.is_param_search = args.param_search
    cfg.slurm_array_id = args.slurm_array_id
    return cfg, args


def _runs_a_model(args) -> bool:
    """Whether the command line asks for more than ``--download``."""
    return bool(args.train or args.test or args.use or args.export
                or args.serve is not None or args.param_search)


def setup_env_and_cfg(cfg, mesh=None):
    """Per-run folders (as ``run.py:setup_env_and_cfg``) and the snapshot
    of the resolved config; → the log folder. On a mesh every rank takes
    the first rank's run name, and only that rank creates anything."""
    root = os.path.expanduser(cfg.env.root_path)
    stamp = [time.strftime("%Y-%m-%dT%H-%M-%S")]
    if mesh is not None:
        torch.distributed.broadcast_object_list(stamp, src=0,
                                                group=mesh.control)
    run_name = f"{cfg.name}_{stamp[0]}"
    cfg.env.this_runs_folder = os.path.join(
        root + cfg.env.runs_subpath, run_name
    )
    cfg.env.this_runs_tensorboard_log_folder = os.path.join(
        root + cfg.env.tensorboard_subpath, run_name
    )
    log_dir = root + cfg.env.log_subpath
    if mesh is not None and not mesh.lead:
        return log_dir
    os.makedirs(cfg.env.this_runs_folder, exist_ok=True)
    os.makedirs(cfg.env.this_runs_tensorboard_log_folder, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.env.this_runs_folder, "config.ini"))
    return log_dir


def deployment_state(cfg, gan: WindFieldGAN, no_ema: bool, status):
    """The state ``--use``, ``--serve`` and ``--export`` run: the weights of
    ``env.generator_load_path`` (``ckpt.load_generator_state``), or random
    ones, with a warning, where none is set; then the EMA slot in G's
    place where there is one, unless ``no_ema``."""
    path = cfg.env.generator_load_path
    if path:
        state = ckpt.load_generator_state(cfg, gan, path)
        status.info(f"loaded generator from {path}")
    else:
        # without weights the EMA slot holds a copy of the random init
        state = dataclasses.replace(ckpt.training_example(cfg, gan),
                                    params_G_ema=None)
        status.warning("no generator_load_path set: running "
                       "freshly-initialized RANDOM weights")
    if state.params_G_ema is not None and not no_ema:
        state = dataclasses.replace(state, params_G=state.params_G_ema)
        status.info("using EMA generator weights for inference")
    return state


def main(argv=None):
    """Run the mode the command line asks for; → the trials' records
    (``--param_search``), the final training state (``--train``), the test
    averages (``--test``), the state whose G was run (``--use``), the
    artifact's header (``--export`` alone), the stopped server
    (``--serve``) or the cached hours' names (``--download`` alone)."""
    cfg, args = argv_to_cfg(argv)
    if args.train and not args.param_search:
        return _train_main(cfg, args)
    if world_size_from_env() > 1:
        raise ValueError(
            "--test, --use, --serve, --export, --param_search and "
            "--download alone run in one process; this is one of "
            f"{world_size_from_env()} (start it without torchrun)")
    # a download alone reads and writes files only
    device = resolve_device(args.device) if _runs_a_model(args) else None
    return _main(cfg, args, device)


def _train_main(cfg, args):
    """``--train``: on a mesh under ``torchrun``, else in this process;
    the process group is destroyed at the end. → the final state (None on
    an idle rank)."""
    batch = cfg.dataset_train.batch_size if cfg.dataset_train else 1
    world = world_size_from_env()
    # raises for more ranks than run
    n, tp, s = data_axis(cfg.parallel, world, batch)
    if "RANK" not in os.environ:  # not under torchrun: one process
        return _main(cfg, args, resolve_device(args.device))
    device = init_distributed(args.device)
    try:
        mesh = make_mesh(n, tp, s, devices=device)
        if mesh.idle:
            return None
        return _main(cfg, args, resolve_device(device), mesh)
    finally:
        torch.distributed.destroy_process_group()


def _main(cfg, args, device, mesh=None):
    log_dir = setup_env_and_cfg(cfg, mesh)
    level = getattr(logging, args.loglevel.upper(), logging.INFO)
    status, _ = setup_loggers(
        log_dir, also_log_to_terminal=cfg.also_log_to_terminal, level=level
    )
    status.info(f"run folder: {cfg.env.this_runs_folder}")
    if device is not None:
        status.info(f"device: {device}"
                    + (f" ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else ""))

    lead = mesh is None or mesh.lead
    if not lead:  # the first rank writes the data caches, then the rest
        mesh.barrier()
    if args.download and lead:
        g = cfg.gan_config
        names = download_dataset(
            cfg.env.data_root, date(*g.start_date), date(*g.end_date),
            number_of_z_layers=g.number_of_z_layers)
        status.info(f"download finished: {len(names)} hours cached")
        if device is None:
            return names
    ds_train, ds_test, ds_val, x, y = preprocess(
        cfg, synthetic=args.synthetic,
        synthetic_hours=args.synthetic_hours,
        synthetic_size=args.synthetic_size,
    )
    if mesh is not None and lead:
        try:  # the train split's memmap
            ds_train.use_npcache()
        except (OSError, ValueError):
            pass  # the loop tries again, and says why it falls back
        finally:
            mesh.barrier()
    status.info(f"datasets: train {len(ds_train)} / test {len(ds_test)} / "
                f"val {len(ds_val)}")
    if cfg.is_param_search:
        n_shards = max(int(os.environ.get("N_SHARDS", "1")), 1)
        return param_search(
            cfg, ds_train, ds_val, x, y, num_samples=args.num_samples,
            shard_index=cfg.slurm_array_id % n_shards, num_shards=n_shards,
            grace_period=args.asha_grace, reduction_factor=args.asha_eta,
            device=device)
    if cfg.is_train:
        return train(cfg, ds_train, ds_val, x, y, max_steps=args.max_steps,
                     device=device,
                     profile_dir=(cfg.env.this_runs_tensorboard_log_folder
                                  if args.profile else None), mesh=mesh)
    if cfg.is_test:
        return run_test(cfg, ds_test, x, y, ema=args.test_ema, device=device)

    state = deployment_state(cfg, WindFieldGAN(cfg, x, y, device=device),
                             args.no_ema, status)
    g = cfg.gan_config
    patch = g.slice_size if g.enable_slicing else len(x)
    lr_tile = patch // cfg.scale
    header = None
    if args.export:
        header = export_generator(cfg, state.params_G, args.export,
                                  lr_size=(lr_tile, lr_tile),
                                  norm_stats=ds_test.stats)
        status.info(f"exported generator -> {args.export} "
                    f"(platforms {header['platforms']}, "
                    f"lr_shape {header['lr_shape']})")
    if cfg.is_use:
        run_use(cfg, ds_test, x, y, state=state, device=device)
    if args.serve is None:
        return state if cfg.is_use else header
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.server import serve, warmup

    sr = WindFieldSR(cfg, state.params_G, device=device,
                     norm_stats=ds_test.stats)
    del state
    for n_calib, quantize, part in (
            (args.serve_int8, sr.quantize, "head"),
            (args.serve_int8_trunk, sr.quantize_trunk, "trunk")):
        if n_calib > 0:
            rng_np = np.random.default_rng(0)
            n = min(n_calib, len(ds_test))
            quantize(np.stack([ds_test.get(i, rng_np)[0]
                               for i in range(n)]))
            status.info(f"int8 serving {part} calibrated over {n} test "
                        f"samples")
    lr_shape = (lr_tile, lr_tile, g.number_of_z_layers, cfg.lr_num_channels)
    if args.serve_warmup:
        warmup(sr, lr_shape, (patch, patch, g.number_of_z_layers, 1),
               [int(b) for b in args.serve_warmup.split(",")], log=status)
    status.info(
        f"serving on 0.0.0.0:{args.serve} "
        f"(POST /v1/upscale[_physical|_tiled], GET /v1/health; "
        f"tile {lr_tile} LR px)"
    )
    allowed = None
    if args.serve_strict_shapes:
        allowed = [lr_shape]
        status.info(f"strict shapes: /v1/upscale pinned to {allowed}")
    return serve(sr, host="0.0.0.0", port=args.serve, log=status,
                 block=True, tile=lr_tile, allowed_shapes=allowed)


if __name__ == "__main__":
    main()
