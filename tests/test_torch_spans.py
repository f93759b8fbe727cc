"""The port's spans (``utils/spans.py``): off they record nothing, on (by
``enable()`` or a running profiler) they record every span from any thread
into a bounded ring; the serving path and a training step record theirs in
order, and a step with spans on leaves the same state, bit for bit, as one
with spans off. CPU."""

import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_tiny import COORDS, HR_SHAPE, LR_SHAPE, make_batch, tiny_cfg
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.eval.server import serve
from gan_sr_wind_field_tpu_torch.models.generator import build_generator
from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
from gan_sr_wind_field_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _fresh_ring():
    spans.enable(False)
    spans.clear()
    yield
    spans.enable(False)
    spans.clear()


def _names(ss):
    return [s.name for s in ss]


def _all_kinds():
    """One span of each kind: ``span``, ``device_span`` around a
    differentiated computation, ``mark``."""
    x = torch.ones(3, requires_grad=True)
    with spans.span("a", k=1) as a:
        a.set(n=2)
        with spans.device_span("b") as b:
            (u,) = b.inputs(x)
            y = b.output(u * 2.0)
    y.sum().backward()
    now = time.perf_counter()
    spans.mark("c", now - 0.5, now)
    return x.grad


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    assert not spans.active()
    assert torch.equal(_all_kinds(), torch.full((3,), 2.0))
    assert spans.read() == [] and opened == []


def test_enable_records_each_kind():
    spans.enable()
    grad = _all_kinds()
    assert torch.equal(grad, torch.full((3,), 2.0))
    got = {s.name: s for s in spans.read()}
    assert set(got) == {"a", "b", "c"}
    assert got["a"].attrs == {"k": 1, "n": 2}
    assert got["a"].t0 <= got["b"].t0 <= got["b"].t1 <= got["a"].t1
    assert abs(got["c"].t1 - got["c"].t0 - 0.5) < 1e-9
    # on the CPU a device span is a host span: no events
    assert all(s.device_ms is None for s in got.values())
    assert {s.thread for s in got.values()} == {"MainThread"}
    assert [s.name for s in spans.read(names=("a",))] == ["a"]
    t = got["a"].t1
    assert "a" not in _names(spans.read(t0=t + 1e-6))


def test_a_running_profiler_turns_spans_on():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        _all_kinds()
    assert not spans.active()
    assert set(_names(spans.read())) == {"a", "b", "c"}
    seen = {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name() in ("a", "b", "b.backward")}
    # ranges: the spans', and the device span's backward; host ranges
    # that the profiler does not mirror onto the device's timeline
    assert set(seen) == {"a", "b", "b.backward"}
    assert not any(e.is_user_annotation() for e in seen.values())


def test_the_ring_stays_bounded():
    spans.enable()
    for i in range(spans.RING + 100):
        spans.mark("m", float(i), float(i))
    ss = spans.read()
    assert len(ss) == spans.RING and ss[0].t0 == 100.0


def test_four_threads_lose_no_span():
    spans.enable()
    per, threads = 4000, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(4):
            def work(k=k):
                for i in range(per):
                    with spans.span(f"t{k}", i=i):
                        pass
            threads.append(threading.Thread(target=work, name=f"w{k}"))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    ss = spans.read()
    for k in range(4):
        mine = [s for s in ss if s.name == f"t{k}"]
        assert sorted(s.attrs["i"] for s in mine) == list(range(per))
        assert {s.thread for s in mine} == {f"w{k}"}


@pytest.fixture(scope="module")
def backend():
    cfg = tiny_cfg(True)
    params = build_generator(cfg, 0).state_dict()
    return WindFieldSR(cfg, params, device="cpu")


def _post(port, lr, z):
    buf = io.BytesIO()
    np.savez(buf, lr=lr, z=z)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/upscale",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))["sr"]


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                timeout=60) as resp:
        return json.loads(resp.read())


def test_one_request_records_its_spans_in_order(backend):
    lr, _, z = make_batch(0, n=1)
    spans.enable()
    srv = serve(backend, host="127.0.0.1", port=0, max_wait_ms=5.0)
    try:
        sr = _post(srv.server_address[1], lr[0], z[0])
        # the handler records its encode after the reply is on the wire
        deadline = time.monotonic() + 10.0
        while (not spans.read(names=("http.encode",))
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        srv.close()
    np.testing.assert_allclose(sr, backend.upscale(lr, z)[0], rtol=1e-5,
                               atol=1e-6)
    got = {}
    for s in spans.read():
        got.setdefault(s.name, s)  # the request's, before the check's
    decode, queue_, batch, encode = (got[k] for k in (
        "http.decode", "batcher.queue", "batcher.batch", "http.encode"))
    assert decode.t1 <= queue_.t0 <= queue_.t1 <= batch.t0
    assert batch.t1 <= encode.t0
    assert decode.attrs == {"n": 1} and encode.attrs == {"n": 1}
    assert batch.attrs == {"n": 1, "pad_to": 1}
    wait = got["http.wait"]
    assert wait.t0 <= batch.t0 <= batch.t1 <= wait.t1
    for inner in ("batcher.stack", "serve.h2d", "serve.generate",
                  "G.hr_head", "serve.d2h"):
        assert batch.t0 <= got[inner].t0 <= got[inner].t1 <= batch.t1, inner
    for k in ("batcher.queue", "batcher.collect", "batcher.batch"):
        assert got[k].thread == "windsr-dispatch"
    assert decode.thread == encode.thread != "windsr-dispatch"


@pytest.mark.parametrize("on", [True, False])
def test_stats_percentiles_only_with_spans_on(backend, on):
    spans.enable(on)
    lr, _, z = make_batch(1, n=2)
    srv = serve(backend, host="127.0.0.1", port=0, max_wait_ms=5.0)
    try:
        for i in range(2):
            _post(srv.server_address[1], lr[i], z[i])
        stats = _stats(srv.server_address[1])
        # the handler records its encode after the reply is on the wire
        deadline = time.monotonic() + 10.0
        while (on and stats["span_ms"]["http.encode"]["count"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
            stats = _stats(srv.server_address[1])
    finally:
        srv.close()
    assert stats["requests"] == 2 and stats["errors"] == 0
    if on:
        assert set(stats["span_ms"]) == {
            "http.decode", "batcher.queue", "http.wait", "batcher.collect",
            "batcher.stack", "batcher.batch", "serve.h2d", "serve.generate",
            "serve.d2h", "http.encode"}
        assert all(v["count"] == 2 and v["p95_ms"] >= v["p50_ms"] >= 0
                   for v in stats["span_ms"].values())
    else:
        assert "span_ms" not in stats
        assert spans.read() == []


def _state_and_batch():
    gan = WindFieldGAN(tiny_cfg(True, g_ema_decay=0.9), COORDS, COORDS,
                       device="cpu")
    return gan, gan.init_state(0, LR_SHAPE, HR_SHAPE), make_batch(2)


def _flat(state):
    trees = {"G": state.params_G, "G_ema": state.params_G_ema,
             "D": state.params_D, "D_stats": state.batch_stats_D,
             "mu_G": state.opt_state_G.mu, "nu_G": state.opt_state_G.nu,
             "mu_D": state.opt_state_D.mu, "nu_D": state.opt_state_D.nu}
    out = {f"{t}/{k}": v for t, tree in trees.items() for k, v in
           tree.items()}
    out["count_G"] = state.opt_state_G.count
    out["count_D"] = state.opt_state_D.count
    return out


def test_train_steps_record_their_phases_and_leave_the_same_state():
    """A G step and a D step with spans on against the same two with spans
    off: the phases recorded, and every tensor of the state equal."""
    states = []
    for on in (True, False):
        spans.clear()
        spans.enable(on)
        gan, state, batch = _state_and_batch()
        kinds = []
        for _ in range(2):
            state, metrics = gan.train_step(state, *batch, augment=True)
            kinds.append(bool(metrics["is_g_step"]))
        assert kinds == [True, False]
        states.append(_flat(state))
        if on:
            ss = spans.read()
            steps = [s for s in ss if s.name == "train.step"]
            assert [s.attrs["kind"] for s in steps] == ["G", "D"]
            g, d = steps
            inside = {n: [s for s in ss if s.name == n] for n in
                      ("train.begin", "train.augment", "G.losses",
                       "G.grad", "G.adam", "G.ema", "G.hr_head",
                       "D.forward_G", "D.losses", "D.grad", "D.adam")}
            for n in ("G.losses", "G.grad", "G.adam", "G.ema"):
                assert [g.t0 <= s.t0 <= s.t1 <= g.t1 for s in inside[n]] \
                    == [True], n
            for n in ("D.forward_G", "D.losses", "D.grad", "D.adam"):
                assert [d.t0 <= s.t0 <= s.t1 <= d.t1 for s in inside[n]] \
                    == [True], n
            assert len(inside["train.begin"]) == 2
            assert len(inside["train.augment"]) == 2
            # the head runs in G's forward on both steps
            assert len(inside["G.hr_head"]) == 2
        else:
            assert spans.read() == []
    on, off = states
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k
