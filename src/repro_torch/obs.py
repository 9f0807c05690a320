"""In-program tracing: spans, device marks and counters, kept in memory.

One process-wide switch, off by default: ``enable()`` / ``disable()``,
``enabled()``, and ``clear()`` to drop what was recorded.  While it is off,
``span`` returns one shared no-op object and ``count`` returns at once, so
an instrumented call costs one check of the switch.

* ``span(name, stream=None, **attrs)``: a context manager.  While tracing
  is on it appends one ``Span`` record (name, start and end on
  ``time.perf_counter_ns()``, the index of the enclosing span, ``attrs``)
  and holds ``torch.profiler.record_function("repro.<name>")`` open for its
  duration, so that a running profiler shows the span on its own clock.
  With a CUDA ``stream`` it records a timing event on that stream at entry
  and at exit, read lazily, by ``spans()``, into ``Span.device_ms``, so
  timing a span costs no host sync.
* ``count(name, n)``: adds ``n`` (an int, or a 0-d device tensor, added on
  its device) to a named counter; ``counters()`` reads them all once.

Records are plain Python values once read: they outlive whatever made
them, and nothing is written to disk.  The serving engine (``serve/
engine.py``) records ``serve.step`` / ``serve.fetch`` spans with its
tick's device times, kernel 3 (``kernels/replay.py``) a ``replay.kernel``
span and the ``replay.chain_lanes`` counter.

This module imports nothing from the rest of the package.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

__all__ = ["Span", "enable", "disable", "enabled", "clear", "span", "count",
           "spans", "counters"]

#: the prefix of the spans' names on the profiler's clock
PROFILER_PREFIX = "repro."


@dataclasses.dataclass
class Span:
    """One span.  ``parent``: the index in ``spans()`` of the span it ran
    inside (-1: none).  ``device_ms``: the device milliseconds between its
    stream's events (empty where it was given no stream)."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)
    device_ms: list = dataclasses.field(default_factory=list)
    _marks: list = dataclasses.field(default_factory=list, repr=False)
    _index: int = dataclasses.field(default=-1, repr=False)

    @property
    def ms(self) -> float:
        """Host milliseconds from entry to exit."""
        return (self.end_ns - self.start_ns) / 1e6

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _mark(self, stream) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        self._marks.append(ev)

    def _resolve(self) -> None:
        if len(self._marks) > 1:
            self._marks[-1].synchronize()
            self.device_ms = [a.elapsed_time(b) for a, b in
                              zip(self._marks, self._marks[1:])]
        self._marks = []


class _Noop:
    """What ``span`` returns while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Open:
    """A span being recorded."""

    def __init__(self, rec: Span, stream):
        self.rec, self.stream = rec, stream
        self._rf = torch.profiler.record_function(PROFILER_PREFIX + rec.name)

    def __enter__(self) -> Span:
        self._rf.__enter__()
        if self.stream is not None:
            self.rec._mark(self.stream)
        return self.rec

    def __exit__(self, *exc):
        if self.stream is not None:
            self.rec._mark(self.stream)
        self._rf.__exit__(*exc)
        self.rec.end_ns = time.perf_counter_ns()
        stack = _LOCAL.__dict__.get("stack")
        if stack and stack[-1] is self.rec:
            stack.pop()
        return False


_ON = False
_LOCK = threading.Lock()
_LOCAL = threading.local()          # .stack: the thread's open spans
_SPANS: list[Span] = []
_COUNTS: dict = {}                  # name -> int or device tensor


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def clear() -> None:
    """Drop every record and counter (the switch stays as it is)."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
    _LOCAL.__dict__.pop("stack", None)


def span(name: str, stream=None, **attrs):
    """A context manager that records span ``name`` while tracing is on
    (``as`` gives its ``Span``, or a no-op object with the same ``set``
    while tracing is off)."""
    if not _ON:
        return _NOOP
    stack = _LOCAL.__dict__.setdefault("stack", [])
    rec = Span(name, time.perf_counter_ns(), attrs=attrs)
    with _LOCK:
        rec.parent = stack[-1]._index if stack else -1
        rec._index = len(_SPANS)
        _SPANS.append(rec)
    stack.append(rec)
    return _Open(rec, stream)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while tracing is on; a tensor ``n`` is
    added on its device, with no host sync."""
    if not _ON:
        return
    with _LOCK:
        if isinstance(n, torch.Tensor):
            n = n.detach().reshape(()).to(torch.int64)
        old = _COUNTS.get(name)
        _COUNTS[name] = n if old is None else old + n


def spans(name: str = None) -> list:
    """The records since the last ``clear()``, in the order their spans
    were entered (all, or those named ``name``), their device marks read."""
    with _LOCK:
        out = list(_SPANS)
    for rec in out:
        if rec._marks and rec.end_ns:
            rec._resolve()
    return [r for r in out if name is None or r.name == name]


def counters() -> dict:
    """{name: int}: every counter since the last ``clear()``, read once."""
    with _LOCK:
        items = list(_COUNTS.items())
    return {k: int(v) for k, v in items}
