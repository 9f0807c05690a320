"""The program's own records (``repro_torch.obs``) as the per-layer readers
see them after the window: the spans, device readings and counters that
the program recorded while its tracer was on.

Each function returns None where there is nothing to read: the tracer was
off, the program has no tracer, or its records do not match the window.
Device readings that were not measured (the CPU) are None in the records,
and the readers leave them out.
"""
from __future__ import annotations


def _obs():
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def spans(name: str = None):
    """The program's span records since ``obs.clear()`` (those named
    ``name``), or None without a tracer."""
    obs = _obs()
    return None if obs is None else obs.spans(name)


def counters() -> dict:
    obs = _obs()
    return {} if obs is None else obs.counters()


def serve_ticks(run):
    """The window's ticks that ran before the profiler started (all of
    them where it never did), as (``serve.step`` record, its
    ``serve.fetch`` child or None).  The ticks since ``obs.clear()`` match
    ``run.records["steps"]`` one to one; None where they do not."""
    every = spans()
    steps = run.records.get("steps")
    if not every or not steps:
        return None
    idx = [i for i, s in enumerate(every) if s.name == "serve.step"]
    if len(idx) != len(steps):
        return None
    fetch = {s.parent: s for s in every if s.name == "serve.fetch"}
    traced = run.records.get("traced_from")
    first = len(idx) if traced is None else traced[0]
    return [(every[i], fetch.get(i)) for i in idx[:first]] or None


def phase_ms(run, phase: str) -> list:
    """The device milliseconds of every ``phase`` that the profiler-free
    ticks marked (``serve.step``'s ``phases``), measured ones only."""
    return [ms for s, _ in serve_ticks(run) or ()
            for p, ms in s.attrs.get("phases", ()) if p == phase
            and ms is not None]


def mean(xs):
    return sum(xs) / len(xs) if xs else None
