"""TensorBoard writer with a JSONL stream (the port's own copy of
``gan_sr_wind_field_tpu/utils/tb.py``).

Every scalar goes to ``events.jsonl``, always. tensorboardX is imported
only when a writer is made with ``use_tensorboard``, and used only when it
imports; figures go to TensorBoard only (``has_figure_sink``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                import tensorboardX

                self._tb = tensorboardX.SummaryWriter(log_dir=log_dir)
            except ImportError:
                pass

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        rec = {"t": time.time(), "tag": tag, "step": step,
               "values": {k: float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, rec["values"], step)

    @property
    def has_figure_sink(self) -> bool:
        """Whether ``add_figure`` writes anywhere (a TensorBoard writer):
        callers make figures only then, so a run without tensorboardX
        never imports matplotlib."""
        return self._tb is not None

    def add_figure(self, tag: str, figure, step: int):
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
