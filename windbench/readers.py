"""What the per-layer metric files share: roofline shares of the kernels
from the trace's device operations and the work the window's calls
asked of them, the device's idle share, the step's share of the peak.

A reader returns None where the trace holds nothing for it to read, never
0 for a share. Where the profiler saw fewer (or more) launches of a kernel
than the program's wrappers counted, the share is worked out over the
launches it saw, and a note says so on an earlier line.
"""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from windbench import counts
from windbench.trace import Trace, busy_seconds


def _calls(trace: Trace):
    """[(rows, residual mode)] of the trunk kernel's calls in the window."""
    return trace.cell["trunk_calls"]


def trunk_fwd_share(trace: Trace, kernels: Iterable[str], marker: str
                    ) -> Optional[float]:
    """Kernel 1: the least time of the window's trunk calls over the
    device time of the kernels whose names hold one of ``kernels``;
    ``marker`` is the kernel launched once per RDB, which gives the
    launches seen."""
    g = trace.cell["geometry"]
    ops = trace.ops_matching(tuple(kernels))
    calls = _calls(trace)
    if not ops or not calls:
        return None
    least = sum(counts.least_seconds(2.0 * counts.trunk_macs(rows, g),
                                     counts.trunk_fwd_bytes(rows, g, res),
                                     counts.H100_BF16_FLOPS)
                for rows, res in calls)
    return _share(trace, "kernel 1", ops, least, marker,
                  len(calls) * 3 * g.num_rrdb)


def trunk_bwd_share(trace: Trace, kernels: Iterable[str], marker: str
                    ) -> Optional[float]:
    """Kernel 2, over the G steps' backward calls."""
    g = trace.cell["geometry"]
    ops = trace.ops_matching(tuple(kernels))
    calls = [rows for rows, res in _calls(trace) if res]
    if not ops or not calls:
        return None
    least = sum(counts.least_seconds(2.0 * counts.trunk_macs(rows, g),
                                     counts.trunk_bwd_bytes(rows, g),
                                     counts.H100_BF16_FLOPS)
                for rows in calls)
    return _share(trace, "kernel 2", ops, least, marker,
                  len(calls) * 3 * g.num_rrdb)


def stencil_share(trace: Trace, gradient: str, adjoint: str
                  ) -> Optional[float]:
    """Kernels 3 and 4: each launch's bound (bytes, float32 operations)
    over their device time."""
    vox = trace.cell["hr_voxels"]
    n3 = int(trace.counters.get("stencil_launches", 0))
    n4 = int(trace.counters.get("adjoint_launches", 0))
    g_ops = trace.ops_matching((gradient,))
    a_ops = trace.ops_matching((adjoint,))
    if not g_ops and not a_ops:
        return None
    b3 = counts.least_seconds(vox * (3 * 15 + 16), counts.stencil_bytes(vox),
                              counts.H100_FP32_FLOPS)
    b4 = counts.least_seconds(vox * (3 * 17 + 3 * 16),
                              counts.stencil_bytes(vox),
                              counts.H100_FP32_FLOPS)
    for name, seen, want in (("kernel 3", len(g_ops), n3),
                             ("kernel 4", len(a_ops), n4)):
        if seen != want:
            trace.notes.append(f"{name}: the profiler saw {seen} launches, "
                               f"the wrapper counted {want}; the share is "
                               f"over the launches seen")
    t = sum(o.dur for o in g_ops + a_ops)
    return 100.0 * (b3 * len(g_ops) + b4 * len(a_ops)) / t


def _share(trace, label, ops, least, marker, want) -> float:
    seen = sum(1 for o in ops if marker in o.name)
    if seen != want and seen:
        trace.notes.append(f"{label}: the profiler saw {seen} launches of "
                           f"{marker}, the wrappers' calls need {want}; the "
                           f"share is over the launches seen")
        least *= seen / want
    return 100.0 * least / sum(o.dur for o in ops)


def idle_pct(trace: Trace) -> Optional[float]:
    if not trace.ops:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / trace.window_s)


def step_ms(trace: Trace, name: str) -> Optional[float]:
    """The median device time of the window's steps of one kind (CUDA
    events around each ``train_step``)."""
    ms = [s.attrs["ms"] for s in trace.spans if s.name == name
          and "ms" in s.attrs]
    return statistics.median(ms) if ms else None


def train_mfu(trace: Trace) -> Optional[float]:
    c = trace.cell
    g, lr, hr = c["geometry"], c["lr_shape"], c["hr_shape"]
    n_g = sum(1 for s in trace.spans if s.name == "g_step")
    n_d = sum(1 for s in trace.spans if s.name == "d_step")
    if not n_g + n_d:
        return None
    flops = (n_g * counts.g_step_flops(g, lr, hr, c["adversarial"])
             + n_d * counts.d_step_flops(g, lr, hr))
    return 100.0 * flops / trace.window_s / counts.H100_BF16_FLOPS


def backend_seconds(trace: Trace) -> float:
    return sum(s.t1 - s.t0 for s in trace.spans if s.name == "upscale")


def serve_mfu(trace: Trace) -> Optional[float]:
    """The real fields' forwards over the time inside the backend."""
    c = trace.cell
    fields = trace.counters.get("batched_samples", 0)
    t = backend_seconds(trace)
    if not fields or not t:
        return None
    x, y, z = c["lr_field"]
    flops = counts.g_forward_flops(c["geometry"], (int(fields), x, y, z))
    return 100.0 * flops / t / counts.H100_BF16_FLOPS


def batch_fill_pct(trace: Trace) -> Optional[float]:
    real = trace.counters.get("batched_samples", 0)
    pad = trace.counters.get("padded_samples", 0)
    if not real:
        return None
    return 100.0 * real / (real + pad)


def backend_ms_per_field(trace: Trace) -> Optional[float]:
    fields = trace.counters.get("batched_samples", 0)
    if not fields:
        return None
    return 1e3 * backend_seconds(trace) / fields
