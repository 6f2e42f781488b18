"""Named spans at the port's layer boundaries, on the profiler's clock.

Off by default.  Off, :func:`span` checks one flag and returns one shared
null context: no CUDA event, no profiler range, no allocation.  On
(:func:`enable`), each span opens a ``torch.profiler.record_function`` of
its name, so that its range lands in a ``torch.profiler`` trace beside
the kernels it launched, and records its host interval
(``perf_counter_ns``) and its device interval (two CUDA events on the
current stream; on the CPU the host interval)::

    from akbx_torch import spans

    spans.enable("cuda")
    for i in range(n):
        spans.step(i)
        ...                          # the program's calls
    by_path = spans.summary(spans.take())
    spans.disable()

The spans of the program:

* ``systems.build``: each system builder (``build_kb``,
  ``build_wolter_3_1``, both Wolter III+III builders);
* ``trace.run``, with ``trace.chief`` (the f64 chief trace and the
  deviation constants), ``trace.k1`` (K1 and its constants),
  ``trace.tilt`` (the tilt reductions, the pre-tilt focus, the detector
  scalars), ``trace.k2`` (K2) and ``trace.finish`` (the f64 fields, the
  demeaned ``w32``, the wavefront);
* ``twin.backward``: the fast engine's backward, with ``twin.rebuild`` (the
  float64 twin run again under autograd; its chief trace shows as
  ``twin.backward/twin.rebuild/trace.chief``) and ``twin.vjp`` (its
  ``autograd.grad``);
* ``ring``: one ``parallel.sharding.huygens_ring`` call, with ``ring.sum``
  (the sum of the resident block, once a ring step) and ``ring.wait`` (the
  wait for the next block, in each of the P - 1 steps that sent one);
* ``huygens:<stage>``: a stage of ``wave.propagate_stages``;
* the names of ``utils.stage_timer``.

The last two were profiler ranges before the spans, and stay bare ranges
while the spans are off (:func:`span_or_range`), so that a profiler trace
names them either way.

A span's parent is the span open around it on the same thread; a span
opened with none open there is a root.  The fast engine's backward runs on
autograd's device thread, so ``twin.backward`` is a root path of its own.
Every span carries the step id last set by :func:`step`, whatever its
thread.  Records stay in memory until :func:`take`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

_NULL = contextlib.nullcontext()
_device: torch.device | None = None
_step: int | None = None
_ids = itertools.count()
_lock = threading.Lock()
_closed: list = []
_local = threading.local()


class Record(NamedTuple):
    """One closed span.  ``start_ms``/``end_ms``: its device interval in
    milliseconds from the start of the earliest span of its device in its
    :func:`take` (CUDA events on a card; the host interval on the CPU)."""

    id: int
    parent: int | None
    name: str
    path: str
    step: int | None
    start_ms: float
    end_ms: float

    @property
    def ms(self) -> float:
        return self.end_ms - self.start_ms


def enable(device) -> None:
    """Switch the spans on, timing the device on ``device`` (a CUDA
    device: events; else the host)."""
    global _device
    _device = torch.device(device)


def disable() -> None:
    global _device
    _device = None


def enabled() -> bool:
    return _device is not None


def step(i: int) -> None:
    """The step id that every span opened from now on carries."""
    global _step
    _step = int(i)


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


class _Span:
    __slots__ = ("name", "device", "path", "id", "parent", "step", "range",
                 "t0", "t1", "ev0", "ev1")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.ev0 = self.ev1 = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.id
        self.path = self.name if up is None else f"{up.path}/{self.name}"
        self.id = next(_ids)
        self.step = _step
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.device.type == "cuda":
            self.ev0 = self._event()
        self.t0 = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.device.type == "cuda":
            self.ev1 = self._event()
        _stack().pop()
        self.range.__exit__(*exc)
        with _lock:
            _closed.append(self)
        return False


def span(name: str):
    """A context manager: the span ``name`` where the spans are on, else
    the shared null context."""
    if _device is None:
        return _NULL
    return _Span(name, _device)


def span_or_range(name: str):
    """The span ``name`` where the spans are on, else a bare
    ``torch.profiler.record_function`` of that name."""
    if _device is None:
        return torch.profiler.record_function(name)
    return _Span(name, _device)


def spanned(name: str):
    """Decorator: the whole of each call in the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _device is None:
                return fn(*args, **kwargs)
            with _Span(name, _device):
                return fn(*args, **kwargs)
        return call
    return wrap


def take() -> list:
    """The spans closed since the last call, as :class:`Record` in order
    of their start, and forget them.  Synchronizes each card that timed
    one, once."""
    with _lock:
        done, _closed[:] = sorted(_closed, key=lambda s: s.t0), []
    first = {}
    for s in done:
        first.setdefault(s.device, s)
    for dev in first:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def at(s, ev, ns):
        ref = first[s.device]
        if ev is None:
            return (ns - ref.t0) * 1e-6
        return ref.ev0.elapsed_time(ev)

    return [Record(s.id, s.parent, s.name, s.path, s.step,
                   at(s, s.ev0, s.t0), at(s, s.ev1, s.t1)) for s in done]


def _covered(lo: float, hi: float, parts) -> float:
    """The length of [lo, hi] that the union of ``parts`` covers."""
    total, end = 0.0, lo
    for a, b in sorted(parts):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def summary(records) -> dict:
    """For each span path: ``count``, ``ms`` (each occurrence's duration,
    device milliseconds) and ``self_ms`` (each occurrence's duration less
    the part its children's intervals cover)."""
    kids = defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.parent].append((r.start_ms, r.end_ms))
    out = {}
    for r in records:
        d = out.setdefault(r.path, {"count": 0, "ms": [], "self_ms": []})
        d["count"] += 1
        d["ms"].append(r.ms)
        d["self_ms"].append(r.ms - _covered(r.start_ms, r.end_ms,
                                            kids[r.id]))
    return out
