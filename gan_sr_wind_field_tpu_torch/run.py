"""Command line of the port: ``python -m gan_sr_wind_field_tpu_torch.run``.

Counterpart of the root ``run.py`` for the modes the port has: argv →
``Config``, the run folders, the config snapshot and the loggers, then
``--train`` on ``--synthetic`` data::

    python -m gan_sr_wind_field_tpu_torch.run --train --synthetic \\
        --synthetic_hours 240 --synthetic_size 128 \\
        --cfg configs/milestone9k.ini

It trains on the card; ``--device cpu`` runs the plain PyTorch path on the
CPU instead, and without either a card or that flag it raises. The other
mode flags of ``run.py`` are accepted and raise ``NotImplementedError``
naming what is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from gan_sr_wind_field_tpu_torch.config import Config
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.train.loop import train
from gan_sr_wind_field_tpu_torch.utils.logging import setup_loggers

_EVAL = "the eval chain (eval/test_loop.py)"
_SERVE = ("serving through run.py; the port serves with "
          "python -m gan_sr_wind_field_tpu_torch.eval.server")
_SEARCH = "the hyperparameter search (search/, ASHA)"
# run.py's other flags: their defaults and what they need
_NOT_PORTED = {
    "test": (False, _EVAL), "test_ema": (False, _EVAL),
    "use": (False, _EVAL), "no_ema": (False, _EVAL),
    "export": (None, "eval/export.py"),
    "serve": (None, _SERVE), "serve_warmup": ("", _SERVE),
    "serve_strict_shapes": (False, _SERVE),
    "serve_int8": (0, "quantization (ops/quant.py)"),
    "serve_int8_trunk": (0, "quantization (ops/quant_trunk.py)"),
    "download": (False, "data/downloader.py (no network: use --synthetic)"),
    "param_search": (False, _SEARCH), "num_samples": (250, _SEARCH),
    "asha_grace": (1200, _SEARCH), "asha_eta": (3, _SEARCH),
    "slurm_array_id": (1, _SEARCH),
    "profile": (False, "profiling of the first iterations"),
}


def argv_to_cfg(argv=None):
    p = argparse.ArgumentParser(
        description="wind-field super-resolution GAN, PyTorch port")
    p.add_argument("--cfg", default="configs/local.ini",
                   help="config INI path")
    p.add_argument("--train", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use analytic synthetic data (the only source "
                        "the port has)")
    p.add_argument("--synthetic_hours", type=int, default=48,
                   help="number of hourly synthetic samples to generate")
    p.add_argument("--synthetic_size", type=int, default=64,
                   help="horizontal extent of the synthetic domain; larger "
                        "than slice_size gives true random-patch training")
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
    if not args.train:
        p.error("nothing to do: the port has --train only")

    cfg = Config.from_ini(args.cfg)
    cfg.is_train = True
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


def main(argv=None):
    """Train as the command line asks; → the final training state."""
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

    ds_train, _, ds_val, x, y = preprocess(
        cfg, synthetic=args.synthetic,
        synthetic_hours=args.synthetic_hours,
        synthetic_size=args.synthetic_size,
    )
    status.info(f"datasets: train {len(ds_train)} / val {len(ds_val)}")
    return train(cfg, ds_train, ds_val, x, y, max_steps=args.max_steps,
                 device=device)


if __name__ == "__main__":
    main()
