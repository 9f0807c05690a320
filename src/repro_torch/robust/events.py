"""Degradation-event log: fallbacks and recoveries made observable.

Counterpart of ``repro/robust/events.py`` (pure Python, copied).  One
process-wide, append-only log that every degradation writes to, so stats
can show *that* and *why* a slow path ran; the serving engine reads it for
``stats["degradation_events"]``.  Readers hold a ``cursor()`` and ask for
events ``since(cursor)``, so one reader never hides events from another.
``clear()`` exists for test isolation.

Appends are thread-safe: each event is stamped, under the log lock, with a
process-monotonic ``seq`` that survives ``clear()``.

This module imports nothing from the rest of the package.
"""
from __future__ import annotations

import dataclasses
import threading
import time

__all__ = ["DegradationEvent", "record", "log", "cursor", "since", "count",
           "clear"]


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    component: str          # e.g. "pallas.replay", "engine.tick_sync"
    reason: str             # "vmem_budget" | "kernel_failure" |
    #                         "validator_alarm" | "sync_timeout" |
    #                         "l1_demotion" (hierarchical L1 exceeds the
    #                         VMEM budget; L1L2 falls to the jnp twin) |
    #                         "smem_budget" (kernel 3 does not take the
    #                         shape; cuda replay runs the chunked path) | ...
    fallback_from: str = ""  # rung/path abandoned ("" for non-ladder events)
    fallback_to: str = ""    # rung/path taken instead
    detail: str = ""
    time_unix: float = 0.0
    seq: int = -1            # process-monotonic order stamp (-1 = unstamped)


_LOCK = threading.Lock()
_LOG: list[DegradationEvent] = []
_SEQ = 0                     # never rewinds — not even on clear()


def record(component: str, reason: str, fallback_from: str = "",
           fallback_to: str = "", detail: str = "") -> DegradationEvent:
    """Append one event; returns it (handy for in-line logging).  The
    ``seq`` stamp is assigned under the log lock, so concurrent recorders
    get distinct, monotonically increasing stamps in append order."""
    global _SEQ
    with _LOCK:
        ev = DegradationEvent(component=component, reason=reason,
                              fallback_from=fallback_from,
                              fallback_to=fallback_to, detail=detail,
                              time_unix=time.time(), seq=_SEQ)
        _SEQ += 1
        _LOG.append(ev)
    return ev


def log() -> tuple[DegradationEvent, ...]:
    """The full event log (immutable snapshot)."""
    with _LOCK:
        return tuple(_LOG)


def cursor() -> int:
    """Position marker: pass to ``since``/``count`` to scope a reader to
    events recorded after this call."""
    with _LOCK:
        return len(_LOG)


def since(start: int) -> tuple[DegradationEvent, ...]:
    with _LOCK:
        return tuple(_LOG[start:])


def count(component: str | None = None, reason: str | None = None,
          start: int = 0) -> int:
    """Number of events (optionally filtered) recorded at/after ``start``."""
    return sum(
        1 for ev in since(start)
        if (component is None or ev.component == component)
        and (reason is None or ev.reason == reason)
    )


def clear() -> None:
    """Drop all events — test isolation only; production readers use
    cursors so they never need to mutate the log."""
    with _LOCK:
        _LOG.clear()
