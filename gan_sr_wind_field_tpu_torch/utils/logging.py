"""Run loggers: 'status' (human-readable progress) and 'train' (loss lines)
(the port's own copy of ``gan_sr_wind_field_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys


def setup_loggers(log_dir: str, also_log_to_terminal: bool = True,
                  level: int = logging.INFO):
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
