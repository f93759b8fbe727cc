"""Command line of the port: ``python -m gan_sr_wind_field_tpu_torch.run``.

Counterpart of the root ``run.py`` for the modes the port has: argv →
``Config``, the run folders, the config snapshot and the loggers, the
``--synthetic`` data, then one of

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
or that flag it raises. ``--download`` is accepted and raises
``NotImplementedError``: there is no network (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from gan_sr_wind_field_tpu_torch.config import Config
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.eval.export import export_generator
from gan_sr_wind_field_tpu_torch.eval.test_loop import run_test, run_use
from gan_sr_wind_field_tpu_torch.search.driver import param_search
from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.train.loop import train
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers

# run.py's other flags: their defaults and what they need
_NOT_PORTED = {
    "download": (False, "data/downloader.py (no network: use --synthetic)"),
}


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
                   help="use analytic synthetic data (the only source "
                        "the port has)")
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
    for flag, (default, _) in _NOT_PORTED.items():
        if isinstance(default, bool):
            p.add_argument(f"--{flag}", action="store_true",
                           help=argparse.SUPPRESS)
        else:
            p.add_argument(f"--{flag}", default=default,
                           type=type(default) if default is not None
                           else str, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, (default, needs) in _NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} is not ported: it needs {needs} (see ROADMAP.md)")
    if not (args.train or args.test or args.use or args.export
            or args.serve is not None or args.param_search):
        p.error("nothing to do: pass --train, --test, --use, --export, "
                "--serve or --param_search")

    cfg = Config.from_ini(args.cfg)
    cfg.is_train = args.train or args.param_search
    cfg.is_test = args.test
    cfg.is_use = args.use
    cfg.is_param_search = args.param_search
    cfg.slurm_array_id = args.slurm_array_id
    return cfg, args


def setup_env_and_cfg(cfg):
    """Per-run folders (as ``run.py:setup_env_and_cfg``) and the snapshot
    of the resolved config; → the log folder."""
    root = os.path.expanduser(cfg.env.root_path)
    stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
    run_name = f"{cfg.name}_{stamp}"
    cfg.env.this_runs_folder = os.path.join(
        root + cfg.env.runs_subpath, run_name
    )
    cfg.env.this_runs_tensorboard_log_folder = os.path.join(
        root + cfg.env.tensorboard_subpath, run_name
    )
    log_dir = root + cfg.env.log_subpath
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
    artifact's header (``--export`` alone) or the stopped server
    (``--serve``)."""
    cfg, args = argv_to_cfg(argv)
    device = resolve_device(args.device)
    log_dir = setup_env_and_cfg(cfg)
    level = getattr(logging, args.loglevel.upper(), logging.INFO)
    status, _ = setup_loggers(
        log_dir, also_log_to_terminal=cfg.also_log_to_terminal, level=level
    )
    status.info(f"run folder: {cfg.env.this_runs_folder}")
    status.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))

    ds_train, ds_test, ds_val, x, y = preprocess(
        cfg, synthetic=args.synthetic,
        synthetic_hours=args.synthetic_hours,
        synthetic_size=args.synthetic_size,
    )
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
                                  if args.profile else None))
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
