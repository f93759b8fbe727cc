"""The program's own spans: named intervals of its work on the host's
``time.perf_counter()`` clock, kept in memory in a bounded ring.

    with spans.span("batcher.stack"):
        lr = np.stack(...)
    with spans.device_span("G.hr_head") as head:
        x, t = head.inputs(x, t)
        h = ...
        h = head.output(h)

Spans are off unless ``enable()`` was called or a ``torch.profiler`` (or
``torch.autograd.profiler``) profile is running. Off, ``span`` and
``device_span`` check two flags and return one shared context that does
nothing: no clock read, no profiler range, no allocation. On, a span
records (name, thread, t0, t1, attrs) into a ring of the last ``RING``
spans, from any thread; while the profiler runs it is also a range on the
profiler's host timeline, beside the device's operations (and in the
Chrome trace of ``train/loop.py --profile``). The profiler records the
ranges of the thread that started it and of autograd's threads, not of
other threads (the server's dispatcher and handlers). The range is a
function-scope record (``_RecordFunctionFast``), not ``record_function``'s
user scope: the profiler mirrors user-scope ranges onto the device's
timeline as annotations, which a reader of the device's operations would
count as device work.

``device_span`` also records a CUDA timing event pair on the current
stream around its body, and gives the autograd backward of what it wraps
the same: ``inputs`` and ``output`` put identity autograd functions at the
wrapped computation's inputs and output, whose backward records the
backward's first and last event (and a ``<name>.backward`` profiler
range). No event is recorded while the stream captures a CUDA graph, nor
without a CUDA context in use (on the CPU a device span is a host span).
The events are resolved into device milliseconds only by ``read``; nothing
on the hot path waits for the device.

``mark`` records a span whose start was taken earlier (a request's wait
in a queue, from its enqueue time).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.autograd.profiler as _profiler

RING = 65536

_enabled = False


class _Record:
    """A span in the ring; ``events`` holds (start, end) CUDA event pairs,
    the backward's pair appended when the backward has run."""

    __slots__ = ("name", "tid", "thread", "t0", "t1", "attrs", "events",
                 "bwd")

    def __init__(self, name: str, attrs: dict, t0: float = 0.0,
                 t1: float = 0.0):
        th = threading.current_thread()
        self.name, self.tid, self.thread = name, th.ident, th.name
        self.t0, self.t1, self.attrs = t0, t1, attrs
        self.events = None
        self.bwd = None  # (start event, profiler range) while it runs


_ring: "collections.deque[_Record]" = collections.deque(maxlen=RING)


@dataclass(frozen=True)
class Span:
    """A recorded span as ``read`` returns it: host times in seconds on
    ``time.perf_counter()``; ``device_ms`` the summed device time of its
    event pairs (forward and backward), None where it has none."""
    name: str
    thread: str
    tid: int
    t0: float
    t1: float
    attrs: dict
    device_ms: Optional[float] = None


def enable(on: bool = True) -> None:
    """Record spans from now on (``on=False``: only while a profiler
    runs)."""
    global _enabled
    _enabled = bool(on)


def active() -> bool:
    """Whether spans record now."""
    return _enabled or _profiler._is_profiler_enabled


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


class _Off:
    """The context every span is while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def inputs(self, *ts):
        return ts

    def output(self, t):
        return t


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.rec = _Record(name, attrs)
        self._rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _host_range(self.rec.name)
        self.rec.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _ring.append(self.rec)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.rec.attrs.update(attrs)


def _host_range(name: str):
    """An open range on the profiler's host timeline."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _stream_event():
    """A timing event recorded on the current stream; None without a CUDA
    context in use or while the stream captures a graph."""
    if (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _BackwardBegins(torch.autograd.Function):
    """Identity at a device span's output: its backward is the first of
    the span's backward work."""

    @staticmethod
    def forward(ctx, rec, t):
        ctx.rec = rec
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        rec, rf = ctx.rec, None
        if _profiler._is_profiler_enabled:
            rf = _host_range(rec.name + ".backward")
        rec.bwd = (_stream_event(), rf)
        return None, g


class _BackwardEnds(torch.autograd.Function):
    """Identity at a device span's inputs: one node, whose backward runs
    when the gradients of all of them are complete."""

    @staticmethod
    def forward(ctx, rec, *ts):
        ctx.rec = rec
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        rec = ctx.rec
        if rec.bwd is not None:
            e0, rf = rec.bwd
            rec.bwd = None
            e1 = _stream_event()
            if e0 is not None and e1 is not None:
                rec.events.append((e0, e1))
            if rf is not None:
                rf.__exit__(None, None, None)
        return (None, *gs)


class _DeviceSpan(_Span):
    __slots__ = ("_e0",)

    def __enter__(self):
        super().__enter__()
        self.rec.events = []
        self._e0 = _stream_event()
        return self

    def __exit__(self, *exc):
        e1 = _stream_event()
        if self._e0 is not None and e1 is not None:
            self.rec.events.append((self._e0, e1))
        return super().__exit__(*exc)

    def inputs(self, *ts):
        """The wrapped computation's inputs, as the computation should use
        them: the backward's last event is taken when all their gradients
        are complete."""
        grad = [i for i, t in enumerate(ts) if t.requires_grad]
        if not grad or not torch.is_grad_enabled():
            return ts
        out = list(ts)
        for i, t in zip(grad, _BackwardEnds.apply(self.rec,
                                                 *(ts[i] for i in grad))):
            out[i] = t
        return tuple(out)

    def output(self, t):
        """The wrapped computation's output, as its callers should see it:
        the backward's first event is taken when its gradient arrives."""
        if not t.requires_grad or not torch.is_grad_enabled():
            return t
        return _BackwardBegins.apply(self.rec, t)


def span(name: str, **attrs):
    """A context that records the time of its body as span ``name``; its
    ``set(**attrs)`` adds attributes inside the body."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def device_span(name: str):
    """``span`` that also times its body, and the backward of what its
    ``inputs``/``output`` wrap, on the current CUDA stream."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _DeviceSpan(name, {})


def mark(name: str, t0: float, t1: float, **attrs) -> None:
    """Record span ``name`` from ``t0`` to ``t1`` (``time.perf_counter()``
    seconds), taken earlier, on this thread."""
    if _enabled or _profiler._is_profiler_enabled:
        _ring.append(_Record(name, attrs, t0, t1))


def _device_ms(events) -> Optional[float]:
    if not events:
        return None
    total = 0.0
    for e0, e1 in events:
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total


def read(t0: Optional[float] = None, t1: Optional[float] = None,
         names: Optional[Iterable[str]] = None) -> list:
    """The ring's spans that overlap [t0, t1] (either end open where None)
    and, with ``names``, have one of them, in the order they ended; a
    device span's events are resolved here (waiting for them)."""
    keep = None if names is None else frozenset(names)
    out = []
    for r in _ring.copy():
        if ((keep is not None and r.name not in keep)
                or (t0 is not None and r.t1 < t0)
                or (t1 is not None and r.t0 > t1)):
            continue
        out.append(Span(r.name, r.thread, r.tid, r.t0, r.t1,
                        dict(r.attrs), _device_ms(r.events)))
    return out
