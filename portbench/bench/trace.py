"""The traced run's reduction: ``torch.profiler`` over the measured window
(or its last ``last_s`` seconds), read as a device timeline.

The harness marks its own calls into the program with ``span(name)``
(``torch.profiler.record_function("pb.<name>")``), one ``pb.traced`` span
around the part of the window traced.  After the window the kineto events are read
once, straight from the profiler's results (no per-event Python objects
beyond one pass), into:

* the device operations (kernels, copies, sets) with their names,
  intervals and the harness span that launched them (by the correlation id
  of their runtime call);
* the busy time: the union of the device intervals inside the window;
* the idle gaps: the window's time outside that union, each named by what
  the host was doing at its middle (the innermost traced host operation,
  else the harness span, else ``host``); gaps shorter than
  ``SHORT_GAP_NS`` (between the kernels of one graph or one burst) are
  summed under one label of their own.

A traced serving window holds millions of device operations, so the
reduction is in numpy after one pass over the events.

Nothing here substitutes a host time for a device time: a reader that finds
no device record returns None.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

PREFIX = "pb."
#: a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 160
#: idle gaps shorter than this are summed under SHORT_GAP, not named one
#: by one
SHORT_GAP_NS = 20_000
SHORT_GAP = "gaps under 20 us"


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")()) * 1000


@dataclasses.dataclass
class Timeline:
    """One traced window."""

    window: tuple                 # (start ns, end ns)
    names: list                   # device op names
    start: np.ndarray             # int64 ns, device ops
    end: np.ndarray
    span: list                    # harness span of each device op or None
    busy_ns: int
    gaps: dict                    # host label -> idle ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def select(self, name: str = None, span: str = None) -> np.ndarray:
        """Mask of the device ops whose name contains ``name`` and that
        the harness span ``span`` launched (None: any)."""
        keep = np.ones(len(self.names), dtype=bool)
        if name is not None:
            uniq, ids = self._interned()
            keep &= np.isin(ids, [i for i, n in enumerate(uniq)
                                  if name in n])
        if span is not None:
            keep &= np.asarray(self.span, dtype=object) == span
        return keep

    def count(self, name: str = None, span: str = None) -> int:
        return int(self.select(name, span).sum())

    def seconds(self, name: str = None, span: str = None) -> float:
        m = self.select(name, span)
        return float((self.end[m] - self.start[m]).sum()) / 1e9

    def _interned(self) -> tuple:
        """(distinct names, int64 id of each op's name), computed once."""
        if getattr(self, "_ids", None) is None:
            index = {}
            ids = np.fromiter((index.setdefault(n, len(index))
                               for n in self.names), dtype=np.int64,
                              count=len(self.names))
            self._ids = (list(index), ids)
        return self._ids

    def top_ops(self, n: int = 10) -> list:
        uniq, idx = self._interned()
        dur = np.bincount(idx, weights=(self.end - self.start),
                          minlength=len(uniq))
        tot = collections.Counter()
        for nm, d in zip(uniq, dur):
            tot[nm[:NAME_CHARS]] += int(d)
        return [[k, v / 1e9] for k, v in tot.most_common(n)]

    def top_gaps(self, n: int = 10) -> list:
        return [[k, v / 1e9] for k, v in
                collections.Counter(self.gaps).most_common(n)]


class Tracer:
    """``with Tracer(on) as tr:`` around the window; ``tr.span(name)``
    around each harness call into the program; ``tr.timeline`` after.

    With ``last_s`` (and the window's ``seconds``) the profiler starts
    only for the window's last ``last_s`` seconds, when the driver calls
    ``poll()`` between two calls into the program past that point; a
    ``pb.traced`` span marks the part traced.  A window of millions of
    device operations is then read within the run's time."""

    def __init__(self, on: bool, seconds: float = None, last_s: float = None):
        self.on = on
        self.start_at = (None if last_s is None or seconds is None
                         else max(0.0, seconds - last_s))
        self.prof = None
        self.timeline = None
        self.started = False
        #: seconds that starting the profiler took (inside the window when
        #: it starts late)
        self.start_s = 0.0
        #: seconds to stop the profiler and to reduce its events
        self.read_s = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def poll(self):
        """Start the profiler once the window is past ``start_at``."""
        if self.on and not self.started \
                and time.perf_counter() - self._t0 >= self.start_at:
            self._start()

    def _start(self):
        t0 = time.perf_counter()
        self.prof.prepare_trace()
        self.prof.start_trace()
        self._traced = self.span("traced")
        self._traced.__enter__()
        self.started = True
        self.start_s = time.perf_counter() - t0

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            if self.start_at is None:
                self._start()
        self._window = self.span("window")
        self._window.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.started:
            self._traced.__exit__(*exc)
        self._window.__exit__(*exc)
        if self.started:
            t0 = time.perf_counter()
            self.prof.stop_trace()
            t1 = time.perf_counter()
            if exc[0] is None:
                self.timeline = reduce(self.prof.profiler.kineto_results
                                       .events())
            self.read_s = (t1 - t0, time.perf_counter() - t1)
        return False


def _union(start: np.ndarray, end: np.ndarray):
    """Sorted disjoint intervals covering the given ones."""
    if not len(start):
        return []
    order = np.argsort(start, kind="stable")
    s = np.asarray(start, dtype=np.int64)[order]
    e = np.maximum.accumulate(np.asarray(end, dtype=np.int64)[order])
    new = np.nonzero(s[1:] > e[:-1])[0] + 1
    first = np.concatenate([[0], new])
    last = np.concatenate([new - 1, [len(s) - 1]])
    return list(zip(s[first].tolist(), e[last].tolist()))


def _innermost(starts, ends, labels, t: int, reach: int = 256):
    """Label of the latest-starting interval that covers ``t`` (scanning
    back at most ``reach`` intervals), or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if ends[j] >= t:
            return labels[j]
    return None


def reduce(events) -> Timeline:
    """kineto events -> Timeline of the ``pb.window`` span."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    dev_name, dev_s, dev_d, dev_corr = [], [], [], []
    spans = collections.defaultdict(list)
    l_corr, l_s = [], []                      # runtime calls: id, host ns
    host = []                                 # (start, end, name)
    for ev in events:
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                dev_name.append(ev.name())
                dev_s.append(_ns(ev, "start"))
                dev_d.append(_ns(ev, "duration"))
                dev_corr.append(ev.correlation_id())
            continue
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        name = ev.name()
        if ev.is_user_annotation() and name.startswith(PREFIX):
            spans[name[len(PREFIX):]].append((s, e))
            continue
        if name.startswith("cu") and ev.correlation_id():
            l_corr.append(ev.correlation_id())
            l_s.append(s)
        host.append((s, e, name))
    if not spans.get("traced"):
        raise RuntimeError("the trace holds no pb.traced span")
    w0, w1 = spans["traced"][0]

    start = np.array(dev_s, dtype=np.int64)
    end = start + np.array(dev_d, dtype=np.int64)
    keep = (end > w0) & (start < w1)
    names = [n for n, k in zip(dev_name, keep) if k]
    start, end = start[keep], end[keep]
    span = _spans_of(np.array(dev_corr, dtype=np.int64)[keep],
                     np.array(l_corr, dtype=np.int64),
                     np.array(l_s, dtype=np.int64), spans)

    busy = _union(np.clip(start, w0, w1), np.clip(end, w0, w1))
    busy_ns = sum(e - s for s, e in busy)

    host.sort()
    h_s = [s for s, _, _ in host]
    h_e = [e for _, e, _ in host]
    h_n = [n for _, _, n in host]
    inner = _inner_spans(spans)
    edges = np.array([w0] + [x for iv in busy for x in iv] + [w1],
                     dtype=np.int64)
    a, b = edges[0::2], edges[1::2]
    length = b - a
    gaps = collections.Counter()
    short = (length > 0) & (length < SHORT_GAP_NS)
    if short.any():
        gaps[SHORT_GAP] += int(length[short].sum())
    for lo, hi in zip(a[length >= SHORT_GAP_NS].tolist(),
                      b[length >= SHORT_GAP_NS].tolist()):
        mid = (lo + hi) // 2
        label = (_innermost(h_s, h_e, h_n, mid)
                 or _innermost(*inner, mid, reach=1) or "host")
        gaps[label] += hi - lo
    return Timeline(window=(w0, w1), names=names, start=start, end=end,
                    span=span, busy_ns=busy_ns, gaps=dict(gaps))


def _inner_spans(spans: dict) -> tuple:
    """The harness spans other than the window and its traced part
    (disjoint), as sorted starts, ends and names."""
    inner = sorted((s, e, n) for n, iv in spans.items()
                   if n not in ("window", "traced") for s, e in iv)
    return ([s for s, _, _ in inner], [e for _, e, _ in inner],
            [n for _, _, n in inner])


def _spans_of(corr, l_corr, l_s, spans) -> np.ndarray:
    """The harness span that launched each device op (object array, None
    where none did): the span holding the host start of the runtime call
    with the op's correlation id."""
    i_s, i_e, i_n = (np.array(x) for x in _inner_spans(spans))
    out = np.full(len(corr), None, dtype=object)
    if not len(corr) or not len(l_corr) or not len(i_s):
        return out
    order = np.argsort(l_corr, kind="stable")
    l_corr, l_s = l_corr[order], l_s[order]
    pos = np.clip(np.searchsorted(l_corr, corr), 0, len(l_corr) - 1)
    found = l_corr[pos] == corr
    t = l_s[pos]
    k = np.searchsorted(i_s, t, side="right") - 1
    ok = found & (k >= 0) & (i_e[np.clip(k, 0, None)] >= t)
    labels = np.array(list(i_n) + [None], dtype=object)
    return labels[np.where(ok, k, len(i_n))]


def idle_share(tl) -> float:
    """Percent of the traced window with no device operation, or None."""
    if tl is None or tl.window[1] <= tl.window[0] or not len(tl.names):
        return None
    return 100.0 * (1.0 - tl.busy_ns / (tl.window[1] - tl.window[0]))
