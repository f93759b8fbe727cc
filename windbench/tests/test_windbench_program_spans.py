"""The readers of the program's own spans (``windbench/program_spans.py``
and the five metric files over it): on hand-built traces and ring
contents, with nothing to read, and on tiny traced runs on the CPU."""

import importlib.util
import sys

import pytest
import torch

from gan_sr_wind_field_tpu_torch.utils import spans as prog
from gan_sr_wind_field_tpu_torch.utils.spans import Span
from windbench import program_spans as ps
from windbench import run as wb_run
from windbench import trace as wb_trace
from windbench.inputs import ROOT
from windbench.tests import tiny
from windbench.trace import DeviceOp, Trace

W0 = 1000.0  # the window's start on the host clock
SERVE = ("queue_wait_p95_ms.serve", "http_ms_per_request.serve",
         "idle_with_queued_pct.serve", "hr_head_ms_per_field.serve")
TRAIN = ("hr_head_ms.train",)
CPU = torch.device("cpu")
SEED = 2**31 + 4242


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, t0, t1, thread="windsr-dispatch", ms=None, **attrs):
    """A program span at window times t0..t1 (seconds), on the host
    clock."""
    return Span(name, thread, 0, W0 + t0, W0 + t1, attrs, ms)


def _ring(monkeypatch, ss):
    def read(t0=None, t1=None, names=None):
        return [s for s in ss if s.t1 >= t0 and s.t0 <= t1
                and (names is None or s.name in names)]

    monkeypatch.setattr(prog, "read", read)


def _trace(ops=((0.0, 0.2), (0.3, 0.9)), counters=None):
    """A one-second window whose device idles over [0.2, 0.3] and
    [0.9, 1.0]."""
    return Trace(window_s=1.0,
                 spans=[wb_trace.Span("window", W0, W0 + 1.0, {})],
                 counters=counters or {"batched_samples": 4},
                 ops=[DeviceOp("k", a, b - a) for a, b in ops],
                 ranges=[], cell={})


SERVING = [
    # two queue waits, 100 and 130 ms, overlapping the first idle gap
    _span("batcher.queue", 0.15, 0.25),
    _span("batcher.queue", 0.22, 0.35),
    # one outside the window: read leaves it out
    _span("batcher.queue", -5.0, -4.0),
    _span("batcher.collect", 0.18, 0.24),
    _span("batcher.batch", 0.24, 0.5, n=2, pad_to=2),
    _span("batcher.stack", 0.241, 0.26),
    _span("serve.h2d", 0.26, 0.27),
    _span("G.hr_head", 0.31, 0.32, ms=3.0),
    _span("G.hr_head", 0.41, 0.42, ms=5.0),
    # requests 10 + 5, 20 + 1 ms on one handler thread, 2 + 2 on another
    _span("http.decode", 0.21, 0.22, "h1"),
    _span("http.encode", 0.5, 0.505, "h1"),
    _span("http.decode", 0.6, 0.62, "h1"),
    _span("http.encode", 0.7, 0.701, "h1"),
    _span("http.decode", 0.226, 0.228, "h2"),
    _span("http.encode", 0.8, 0.802, "h2"),
]


def test_the_serving_readers_on_a_hand_built_ring(monkeypatch):
    _ring(monkeypatch, SERVING)
    tr = _trace()
    got = {m: _reader(m)(tr) for m in SERVE}
    assert got["queue_wait_p95_ms.serve"] == pytest.approx(128.5)
    assert got["http_ms_per_request.serve"] == pytest.approx(15.0)
    # the union of the waits [0.15, 0.35] over the idle gap [0.2, 0.3]
    assert got["idle_with_queued_pct.serve"] == pytest.approx(10.0)
    assert got["hr_head_ms_per_field.serve"] == pytest.approx(2.0)


def test_the_mapping_is_from_the_window_start(monkeypatch):
    """A wait over the synthetic gap [0.5, 0.6] of the device trace, at
    host time W0 + 0.5: the whole gap is idle with a job queued; the same
    wait a tenth of a second later overlaps half of it."""
    tr = _trace(ops=((0.0, 0.5), (0.6, 1.0)))
    _ring(monkeypatch, [_span("batcher.queue", 0.5, 0.6)])
    assert ps.idle_with_queued_pct(tr) == pytest.approx(10.0)
    _ring(monkeypatch, [_span("batcher.queue", 0.55, 0.65)])
    assert ps.idle_with_queued_pct(tr) == pytest.approx(5.0)


def test_the_training_reader_takes_the_median_g_step(monkeypatch):
    _ring(monkeypatch, [
        _span("train.step", 0.0, 0.3, "MainThread", kind="G"),
        _span("G.hr_head", 0.05, 0.06, "MainThread", ms=4.0),
        _span("train.step", 0.3, 0.5, "MainThread", kind="D"),
        _span("G.hr_head", 0.35, 0.36, "MainThread", ms=1.0),
        _span("train.step", 0.5, 0.8, "MainThread", kind="G"),
        _span("G.hr_head", 0.55, 0.56, "MainThread", ms=6.0),
        _span("train.step", 0.8, 0.95, "MainThread", kind="G"),
        _span("G.hr_head", 0.85, 0.86, "MainThread", ms=7.0),
    ])
    assert _reader("hr_head_ms.train")(_trace()) == pytest.approx(6.0)


def test_idle_by_span_names_each_idle_moment(monkeypatch):
    """Idle [0.2, 0.3] under the dispatcher's collect, stack, upload and
    batch, with jobs queued and two HTTP decodes on their own threads
    meanwhile, and idle [0.9, 1.0] outside any span, nothing queued."""
    _ring(monkeypatch, SERVING)
    rows = {(r[0], r[1]): r[2:] for r in ps.idle_by_span(
        _trace())}
    # the waits span [0.15, 0.35]; the decodes take 12 of collect's 40 ms
    want = {("batcher.collect", True): (0.04, 0.012 / 0.04),
            ("batcher.batch", True): (0.031, 0.0),
            ("batcher.stack", True): (0.019, 0.0),
            ("serve.h2d", True): (0.01, 0.0),
            (ps.OUTSIDE, False): (0.1, 0.0)}
    assert rows.keys() == want.keys()
    for k, (sec, http) in want.items():
        assert rows[k] == pytest.approx([sec, http], abs=1e-9), k
    assert sum(r[0] for r in rows.values()) == pytest.approx(0.2)
    # on another thread nothing is open
    rows = ps.idle_by_span(_trace(),
                           thread="MainThread")
    assert {(r[0], r[1]) for r in rows} == {(ps.OUTSIDE, True),
                                            (ps.OUTSIDE, False)}


@pytest.mark.parametrize("case", ["empty ring", "no ring", "no window",
                                  "no ops"])
def test_each_reader_gives_none_with_nothing_to_read(monkeypatch, case):
    tr = _trace()
    if case == "empty ring":
        _ring(monkeypatch, [])
    elif case == "no ring":  # a program without utils/spans.py
        monkeypatch.setitem(sys.modules,
                            "gan_sr_wind_field_tpu_torch.utils.spans", None)
        monkeypatch.delattr("gan_sr_wind_field_tpu_torch.utils.spans")
    elif case == "no window":
        _ring(monkeypatch, SERVING)
        tr.spans = []
    else:  # the device readers, without device operations or events
        _ring(monkeypatch, [s for s in SERVING if s.name != "G.hr_head"])
        tr.ops = []
    for m in SERVE + TRAIN:
        if case == "no ops" and m in ("queue_wait_p95_ms.serve",
                                      "http_ms_per_request.serve"):
            continue
        assert _reader(m)(tr) is None, m
    if case == "no ops":
        assert ps.idle_by_span(tr) == []


@pytest.mark.parametrize("workload", ["serve.milestone9k.steady",
                                      "train.milestone9k",
                                      "train.fullvol8x3k"])
def test_a_tiny_traced_run_reads_the_program_spans(monkeypatch, workload):
    """On the CPU the span readers read the run's ring; the readers of
    device time find no events and no device operations."""
    tiny.install(monkeypatch)
    torch.set_num_threads(4)
    keep = {}
    orig = wb_trace.breakdown

    def spy(tr, *a, **kw):
        keep["trace"] = tr
        return orig(tr, *a, **kw)

    monkeypatch.setattr(wb_trace, "breakdown", spy)
    res = wb_run.run(tiny.bench(), workload, SEED, 0.5, True, CPU)
    assert res["correct"], res["checks"]
    names = {s.name for s in ps.program_spans(keep["trace"])}
    if workload.startswith("serve"):
        assert {"queue_wait_p95_ms.serve",
                "http_ms_per_request.serve"} <= set(res["metrics"])
        assert res["metrics"]["queue_wait_p95_ms.serve"]["value"] > 0
        assert not {"idle_with_queued_pct.serve",
                    "hr_head_ms_per_field.serve"} & set(res["metrics"])
        assert {"http.decode", "http.wait", "http.encode", "batcher.queue",
                "batcher.collect", "batcher.stack", "batcher.batch",
                "serve.h2d", "serve.generate", "serve.d2h",
                "G.hr_head"} <= names
    else:
        assert "hr_head_ms.train" not in res["metrics"]
        assert {"train.step", "train.begin", "train.augment", "data.batch",
                "G.hr_head"} <= names
        # the phases of each kind of step the window ran
        phases = {"G": {"G.losses", "G.grad", "G.adam"},
                  "D": {"D.forward_G", "D.losses", "D.grad", "D.adam"}}
        for step in ps.program_spans(keep["trace"], ("train.step",)):
            assert phases[step.attrs["kind"]] <= names
    assert all(s.device_ms is None for s in ps.program_spans(keep["trace"]))
