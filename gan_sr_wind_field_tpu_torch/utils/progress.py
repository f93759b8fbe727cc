"""Terminal progress line (the port's own copy of
``gan_sr_wind_field_tpu/utils/progress.py``): it/niter, epoch, rate and
ETA, redrawn in place and rate-limited.
"""

from __future__ import annotations

import sys
import time


class DisplayBar:
    def __init__(self, max_value: int, start_epoch: int = 0, start_it: int = 0,
                 niter: int = 0, stream=None, min_interval: float = 0.5):
        self.max_value = max_value
        self.niter = niter
        self.start_it = start_it
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self._t0 = time.time()
        self._last_draw = 0.0

    def update(self, batch_index: int, epoch: int, it: int):
        now = time.time()
        if now - self._last_draw < self.min_interval and it < self.niter:
            return
        self._last_draw = now
        rate = (it - self.start_it) / max(now - self._t0, 1e-9)
        eta = (self.niter - it) / max(rate, 1e-9)
        frac = it / max(self.niter, 1)
        width = 24
        filled = int(frac * width)
        bar = "█" * filled + "·" * (width - filled)
        msg = (
            f"\r[{bar}] it {it}/{self.niter} epoch {epoch} "
            f"batch {batch_index}/{self.max_value} "
            f"{rate:.2f} it/s ETA {eta/60:.1f}m"
        )
        end = "\n" if it >= self.niter else ""
        self.stream.write(msg + end)
        self.stream.flush()
