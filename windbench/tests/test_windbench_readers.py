"""The per-layer readers on a synthetic trace, a missed launch included."""

import importlib.util

import pytest

from windbench import counts
from windbench.inputs import ROOT, load_json, spec
from windbench.trace import DeviceOp, Span, Trace, breakdown, busy_seconds

G = spec(load_json("configs", "milestone9k")).geometry
ROWS = 32 * 16 * 16 * 10


def reader(name):
    path = ROOT / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m.read


def trace(ops, calls=((ROWS, True), (ROWS, False)), counters=None,
          spans=()):
    cell = {"geometry": G, "trunk_calls": list(calls),
            "lr_shape": (32, 16, 16, 10), "hr_shape": (32, 64, 64, 10),
            "hr_voxels": 32 * 64 * 64 * 10, "adversarial": True,
            "lr_field": (16, 16, 10)}
    return Trace(window_s=2.0, spans=list(spans), counters=counters or {},
                 ops=ops, ranges=[("g_step", 0.0, 1.0)], cell=cell)


def trunk_ops(n_calls, seconds_each, missing=0):
    J = 3 * G.num_rrdb
    ops = []
    for c in range(n_calls):
        for j in range(J):
            ops.append(DeviceOp("void tc_growth_fwd<...>", c, seconds_each
                                / J / 2))
            if c or j >= missing:
                ops.append(DeviceOp("void tc_lff_fwd<...>", c, seconds_each
                                    / J / 2))
    return ops


def test_trunk_forward_share():
    least = sum(counts.least_seconds(2 * counts.trunk_macs(ROWS, G),
                                     counts.trunk_fwd_bytes(ROWS, G, r),
                                     counts.H100_BF16_FLOPS)
                for r in (True, False))
    tr = trace(trunk_ops(2, 0.1))
    got = reader("trunk_fwd_roofline_pct.train")(tr)
    assert got == pytest.approx(100 * least / 0.2, rel=1e-9)
    assert not tr.notes


def test_a_missed_launch_is_worked_out_over_the_launches_seen():
    tr = trace(trunk_ops(2, 0.1, missing=1))
    got = reader("trunk_fwd_roofline_pct.train")(tr)
    J = 3 * G.num_rrdb
    seen_time = 0.2 - 0.1 / J / 2
    least = sum(counts.least_seconds(2 * counts.trunk_macs(ROWS, G),
                                     counts.trunk_fwd_bytes(ROWS, G, r),
                                     counts.H100_BF16_FLOPS)
                for r in (True, False)) * (2 * J - 1) / (2 * J)
    assert got == pytest.approx(100 * least / seen_time, rel=1e-9)
    assert tr.notes and "saw 95" in tr.notes[0]


def test_nothing_to_read_is_none_never_zero():
    tr = trace([])
    for name in ("trunk_fwd_roofline_pct.train",
                 "trunk_bwd_roofline_pct.train",
                 "stencil_roofline_pct.train", "device_idle_pct.train",
                 "forward_mfu_pct.serve", "batch_fill_pct.serve"):
        assert reader(name)(tr) is None


def test_stencil_share_and_its_launch_check():
    vox = 32 * 64 * 64 * 10
    ops = [DeviceOp("grad_fwd_tile<T>", 0.0, 1e-4),
           DeviceOp("grad_fwd_tile<T>", 0.1, 1e-4),
           DeviceOp("grad_adj_tile<T>", 0.2, 1e-4)]
    tr = trace(ops, counters={"stencil_launches": 2, "adjoint_launches": 2})
    got = reader("stencil_roofline_pct.train")(tr)
    b = counts.stencil_bytes(vox) / counts.H100_HBM_BYTES_S
    assert got == pytest.approx(100 * 3 * b / 3e-4, rel=1e-6)
    assert any("kernel 4" in n for n in tr.notes)


def test_idle_share_busy_union_and_breakdown():
    ops = [DeviceOp("a", 0.0, 0.5), DeviceOp("b", 0.25, 0.5),
           DeviceOp("a", 1.5, 0.25)]
    tr = trace(ops)
    assert busy_seconds(tr) == pytest.approx(1.0)
    assert reader("device_idle_pct.train")(tr) == pytest.approx(50.0)
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["a", 0.75]
    assert bd["idle_gaps"][0] == ["g_step", 0.75]
    assert bd["idle_gaps"][1] == ["no benchmark span", 0.25]


def test_serving_readers():
    spans = [Span("upscale", 0.0, 0.1, {"batch": 8}),
             Span("upscale", 0.2, 0.3, {"batch": 8})]
    tr = trace([], calls=[(8 * 16 * 16 * 10, False)] * 2,
               counters={"batched_samples": 12, "padded_samples": 4},
               spans=spans)
    assert reader("batch_fill_pct.serve")(tr) == pytest.approx(75.0)
    assert reader("backend_ms_per_field.serve")(tr) == pytest.approx(
        200.0 / 12)
    mfu = reader("forward_mfu_pct.serve")(tr)
    flops = counts.g_forward_flops(G, (12, 16, 16, 10))
    assert mfu == pytest.approx(100 * flops / 0.2 / 989e12)


def test_step_readers():
    spans = [Span("g_step", 0, 1, {"ms": 3.0}), Span("g_step", 1, 2,
                                                      {"ms": 5.0}),
             Span("d_step", 2, 3, {"ms": 1.0})]
    tr = trace([], spans=spans)
    assert reader("g_step_ms.train")(tr) == 4.0
    assert reader("d_step_ms.train")(tr) == 1.0
    f = (2 * counts.g_step_flops(G, (32, 16, 16, 10), (32, 64, 64, 10), True)
         + counts.d_step_flops(G, (32, 16, 16, 10), (32, 64, 64, 10)))
    assert reader("step_mfu_pct.train")(tr) == pytest.approx(
        100 * f / 2.0 / 989e12)


def test_profile_events_reads_the_benchmark_ranges_from_the_window():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from windbench.trace import Recorder, profile_events

    rec = Recorder(traced=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
        with rec.span("window"):
            with rec.span("g_step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    ops, ranges = profile_events(prof)
    assert ops == []  # no device operation on the CPU
    names = dict((n, (a, b)) for n, a, b in ranges)
    assert set(names) == {"window", "g_step"}
    assert names["window"][0] == 0.0
    assert 0.0 <= names["g_step"][0] <= names["g_step"][1]
    assert names["g_step"][1] <= names["window"][1] < 60.0
