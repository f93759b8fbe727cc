"""Spans, counters and the device trace of one run, and what the per-layer
metric readers read.

Host spans are taken in the benchmark's own files around its calls into
the program (``Recorder.span``); in a traced run each span is also a
``torch.profiler.record_function`` range, so that the device's idle gaps
can be named by what the host was doing. The profiler's device operations
(kernels, copies, sets) give the device's busy time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict


@dataclass
class Recorder:
    """Spans of the measured window (host clock, seconds); ``traced`` turns
    each span into a profiler range too."""
    traced: bool = False
    spans: List[Span] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = None
        if self.traced:
            import torch

            rf = torch.profiler.record_function(f"wb.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(Span(name, t0, t1, attrs))


@dataclass
class DeviceOp:
    name: str
    start: float  # seconds from the window's start
    dur: float


@dataclass
class Trace:
    """What a per-layer reader reads. Times in seconds from the start of
    the window; ``ops`` empty in an untraced run."""
    window_s: float
    spans: List[Span]
    counters: Dict[str, float]
    ops: List[DeviceOp]
    ranges: List[Tuple[str, float, float]]  # host ranges from the profiler
    cell: dict
    notes: List[str] = field(default_factory=list)

    def ops_matching(self, substrings) -> List[DeviceOp]:
        return [o for o in self.ops if any(s in o.name for s in substrings)]


def busy_intervals(ops: List[DeviceOp], t0: float, t1: float):
    """The union of the device operations' intervals clipped to [t0, t1],
    as sorted disjoint (start, end) pairs."""
    iv = sorted((max(o.start, t0), min(o.start + o.dur, t1)) for o in ops
                if o.start + o.dur > t0 and o.start < t1)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.ops, 0.0,
                                                trace.window_s))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by name), and the longest
    idle gaps named by the innermost host range around each gap's start."""
    by_name = defaultdict(float)
    for o in trace.ops:
        by_name[o.name[:120]] += o.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.ops, 0.0, trace.window_s)
    gaps, prev = [], 0.0
    for a, b in busy + [(trace.window_s, trace.window_s)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def host_at(t: float) -> str:
        inner: Optional[Tuple[str, float, float]] = None
        for name, a, b in trace.ranges:
            if a <= t < b and (inner is None or b - a < inner[2] - inner[1]):
                inner = (name, a, b)
        if inner is None:
            return "no benchmark span"
        # inside the window but in no call into the program
        return "between calls" if inner[0] == "window" else inner[0]

    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_at(a), b - a] for a, b in gaps]}


def profile_events(prof):
    """(device operations, host ranges of the benchmark's spans) of a
    finished ``torch.profiler.profile``, in seconds from the start of the
    range ``wb.window`` (of the first device operation where there is
    none). It reads the profiler's raw events and keeps only those two
    kinds, without building the tree of every host operation."""
    from torch.autograd import DeviceType

    ops, ranges = [], []
    start = None
    for e in prof.profiler.kineto_results.events():
        name, cuda = e.name(), e.device_type() == DeviceType.CUDA
        if name.startswith("wb."):
            # a range on the device's timeline too: not an operation
            if cuda:
                continue
            a = e.start_ns()
            ranges.append((name[3:], a, a + e.duration_ns()))
            if name == "wb.window":
                start = a
        elif cuda:
            a = e.start_ns()
            ops.append((name, a, a + e.duration_ns()))
    if start is None:
        start = min((o[1] for o in ops), default=0)
    ops = [DeviceOp(n, (a - start) / 1e9, (b - a) / 1e9) for n, a, b in ops]
    ranges = [(n, (a - start) / 1e9, (b - start) / 1e9) for n, a, b in ranges]
    return ops, ranges
