"""Asynchronous Successive Halving (ASHA) early stopping.

The port's own copy of ``gan_sr_wind_field_tpu/search/asha.py``: the same
rungs, promotion rule and rung files. Replacement for Ray Tune's
ASHAScheduler as configured by the reference (param_search.py:298-303:
time_attr='it', grace_period=1200, reduction_factor=3, metric=PSNR max).
Pure-python bookkeeping: trials report (it, metric) at rung boundaries; a
trial continues past rung k only if its metric is in the top
1/reduction_factor of everything seen at that rung — the asynchronous
variant, so the first trials through a rung always continue.

Sharded sweeps (one driver per card or host) share rung state through
append-only JSONL files: each shard appends its own reports to
``<share_dir>/asha_rungs.shard<k>.jsonl`` and folds in sibling shards' new
records before every promotion decision. That reproduces the reference's
single Ray head making decisions over the *whole* concurrent population
(param_search.py:298-303) without a coordinator process — the files live
in the shared run folder (a network file system across hosts), and
append+scan is safe because records are only ever added.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ASHAScheduler:
    max_t: int
    grace_period: int = 1200
    reduction_factor: int = 3
    mode_max: bool = True
    # cross-shard rung sharing (optional): directory of per-shard JSONLs
    share_dir: Optional[str] = None
    shard_index: int = 0
    # rung iteration -> list of metrics observed at that rung
    rungs: Dict[int, List[float]] = field(default_factory=dict)
    # sibling file path -> byte offset already consumed
    _consumed: Dict[str, int] = field(default_factory=dict)

    def rung_iterations(self) -> List[int]:
        rungs, r = [], self.grace_period
        while r < self.max_t:
            rungs.append(r)
            r *= self.reduction_factor
        return rungs

    # --- cross-shard sharing -------------------------------------------
    def _own_path(self) -> str:
        return os.path.join(
            self.share_dir, f"asha_rungs.shard{self.shard_index}.jsonl"
        )

    def _publish(self, it: int, metric: float) -> None:
        os.makedirs(self.share_dir, exist_ok=True)
        with open(self._own_path(), "a") as f:
            f.write(json.dumps({"it": it, "metric": metric}) + "\n")

    def _sync_siblings(self) -> None:
        """Fold new sibling-shard rung records into local state."""
        own = os.path.abspath(self._own_path())
        pattern = os.path.join(self.share_dir, "asha_rungs.shard*.jsonl")
        for path in sorted(glob.glob(pattern)):
            if os.path.abspath(path) == own:
                continue
            offset = self._consumed.get(path, 0)
            try:
                with open(path) as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            # only consume complete lines (a sibling may be mid-append)
            end = chunk.rfind("\n") + 1
            for line in chunk[:end].splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                self.rungs.setdefault(int(rec["it"]), []).append(
                    float(rec["metric"])
                )
            self._consumed[path] = offset + end

    # --- decisions ------------------------------------------------------
    def report(self, it: int, metric: float) -> bool:
        """Record a rung result. Returns True to continue, False to stop."""
        if it >= self.max_t:
            return False
        if self.share_dir:
            self._publish(it, metric)
            self._sync_siblings()
        vals = self.rungs.setdefault(it, [])
        vals.append(metric)
        if len(vals) < self.reduction_factor:
            return True  # async: early trials promote optimistically
        ranked = sorted(vals, reverse=self.mode_max)
        cutoff_idx = max(len(ranked) // self.reduction_factor, 1) - 1
        cutoff = ranked[cutoff_idx]
        return (metric >= cutoff) if self.mode_max else (metric <= cutoff)
