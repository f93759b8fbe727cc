"""What the readers of the program's own spans share: the window's spans
from the program's ring (``gan_sr_wind_field_tpu_torch/utils/spans.py``),
on the device trace's time axis, and the device's idle time named by the
program's spans.

The ring records while the profiler runs, so a traced run fills it over
the window and an untraced run leaves it empty. A span at host time t
(``time.perf_counter()``, the clock of ``trace.Recorder``) lies at
t - window.t0 on the device trace: ``Recorder.span("window")`` and
``trace.profile_events`` both anchor at the start of ``wb.window``. Where
the program has no ring (a checkout without ``utils/spans.py``), or the
ring holds nothing of the window, a reader returns None.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict
from typing import Optional

import numpy as np

from windbench.trace import DeviceOp, Trace, busy_intervals

DISPATCHER = "windsr-dispatch"
HTTP = ("http.decode", "http.encode")
OUTSIDE = "outside any span"


def window_span(trace: Trace):
    return next((s for s in trace.spans if s.name == "window"), None)


def program_spans(trace: Trace, names=None) -> list:
    """The program's spans (``spans.Span``) that overlap the window, with
    ``names`` where given, their times in seconds from the window's
    start."""
    w = window_span(trace)
    if w is None:
        return []
    try:
        from gan_sr_wind_field_tpu_torch.utils import spans
    except ImportError:
        return []
    return [dataclasses.replace(s, t0=s.t0 - w.t0, t1=s.t1 - w.t0)
            for s in spans.read(w.t0, w.t1, names)]


def queue_wait_p95_ms(trace: Trace) -> Optional[float]:
    ms = [1e3 * (s.t1 - s.t0)
          for s in program_spans(trace, ("batcher.queue",))]
    return float(np.percentile(ms, 95)) if ms else None


def http_ms_per_request(trace: Trace) -> Optional[float]:
    """The median over the window's requests of their decode plus their
    encode: a handler thread serves its connection's requests in turn, so
    each decode goes with the next encode on its thread."""
    by_thread = defaultdict(list)
    for s in program_spans(trace, HTTP):
        by_thread[s.thread].append(s)
    per_request = []
    for ss in by_thread.values():
        ss.sort(key=lambda s: s.t0)
        for s in ss:
            if s.name == "http.decode":
                per_request.append(s.t1 - s.t0)
            elif per_request:
                per_request[-1] += s.t1 - s.t0
    return 1e3 * statistics.median(per_request) if per_request else None


def idle_intervals(trace: Trace):
    """The window's device-idle intervals, as sorted (start, end) pairs
    (the gaps that ``trace.breakdown`` finds, all of them)."""
    gaps, prev = [], 0.0
    for a, b in (busy_intervals(trace.ops, 0.0, trace.window_s)
                 + [(trace.window_s, trace.window_s)]):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_with_queued_pct(trace: Trace) -> Optional[float]:
    """The share of the window in which no device operation ran while a
    job waited in the micro-batcher's queue."""
    if not trace.ops:
        return None
    queued = busy_intervals(
        [DeviceOp(s.name, s.t0, s.t1 - s.t0)
         for s in program_spans(trace, ("batcher.queue",))],
        0.0, trace.window_s)
    if not queued:
        return None
    return (100.0 * _overlap(idle_intervals(trace), queued)
            / trace.window_s)


def hr_head_ms_per_field(trace: Trace) -> Optional[float]:
    ms = [s.device_ms for s in program_spans(trace, ("G.hr_head",))
          if s.device_ms is not None]
    fields = trace.counters.get("batched_samples", 0)
    if not ms or not fields:
        return None
    return sum(ms) / fields


def hr_head_ms_train(trace: Trace) -> Optional[float]:
    """The median over the window's G steps of the head's device time in
    the step, forward and backward."""
    ss = program_spans(trace, ("train.step", "G.hr_head"))
    heads = [s for s in ss if s.name == "G.hr_head"
             and s.device_ms is not None]
    per_step = []
    for step in ss:
        if step.name != "train.step" or step.attrs.get("kind") != "G":
            continue
        ms = [h.device_ms for h in heads if step.t0 <= h.t0 <= step.t1]
        if ms:
            per_step.append(sum(ms))
    return statistics.median(per_step) if per_step else None


def idle_by_span(trace: Trace, thread: str = DISPATCHER) -> list:
    """The window's device-idle time by the innermost program span open
    on ``thread`` at each moment of it (``OUTSIDE`` where none is; the
    queue's spans, on the dispatcher thread too, are not nested and do not
    count) and by whether a job waited in the queue then: rows [span,
    queued, idle seconds, the mean number of HTTP threads inside a decode
    or an encode meanwhile], the longest first. Empty without device
    operations."""
    if not trace.ops:
        return []
    edges = []  # (time, order, kind, span): closes before opens
    for a, b in idle_intervals(trace):
        edges += [(a, 1, "idle", None), (b, 0, "idle", None)]
    for s in program_spans(trace):
        if s.t1 <= s.t0:
            continue
        if s.name == "batcher.queue":
            kind = "queue"
        elif s.name in HTTP:
            kind = "http"
        elif s.thread == thread:
            kind = "open"
        else:
            continue
        edges += [(s.t0, 1, kind, s), (s.t1, 0, kind, s)]
    edges.sort(key=lambda e: (e[0], e[1]))
    idle = queued = http = 0
    stack = []
    rows = defaultdict(lambda: [0.0, 0.0])
    prev = 0.0
    for t, opening, kind, s in edges:
        t = min(max(t, 0.0), trace.window_s)
        if idle and t > prev:
            inner = (max(stack, key=lambda x: (x.t0, -x.t1)).name
                     if stack else OUTSIDE)
            row = rows[(inner, queued > 0)]
            row[0] += t - prev
            row[1] += (t - prev) * http
        prev = t
        step = 1 if opening else -1
        if kind == "idle":
            idle += step
        elif kind == "queue":
            queued += step
        elif kind == "http":
            http += step
        elif opening:
            stack.append(s)
        else:
            stack = [x for x in stack if x is not s]
    return sorted(([name, q, sec, h / sec] for (name, q), (sec, h) in
                   rows.items()), key=lambda r: -r[2])
