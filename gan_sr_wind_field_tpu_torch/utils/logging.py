"""Run loggers: 'status' (human-readable progress) and 'train' (loss lines)
(the port's own copy of ``gan_sr_wind_field_tpu/utils/logging.py``).

In a group of processes (``torchrun``) only rank 0 writes the log files;
the other ranks log warnings and errors to the terminal, their rank in
each line."""

from __future__ import annotations

import logging
import os
import sys

from gan_sr_wind_field_tpu_torch.parallel.mesh import process_rank


def setup_loggers(log_dir: str, also_log_to_terminal: bool = True,
                  level: int = logging.INFO):
    rank = process_rank()
    if rank != 0:
        fmt = logging.Formatter(
            f"%(asctime)s rank {rank} %(levelname)s: %(message)s")
        for name in ("status", "train"):
            log = logging.getLogger(name)
            log.setLevel(logging.WARNING)
            log.handlers.clear()
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(fmt)
            log.addHandler(sh)
        return logging.getLogger("status"), logging.getLogger("train")
    os.makedirs(log_dir, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")

    status = logging.getLogger("status")
    status.setLevel(level)
    status.handlers.clear()
    fh = logging.FileHandler(os.path.join(log_dir, "status.log"))
    fh.setFormatter(fmt)
    status.addHandler(fh)
    if also_log_to_terminal:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        status.addHandler(sh)

    train = logging.getLogger("train")
    train.setLevel(level)
    train.handlers.clear()
    th = logging.FileHandler(os.path.join(log_dir, "train.log"))
    th.setFormatter(logging.Formatter("%(message)s"))
    train.addHandler(th)
    return status, train
