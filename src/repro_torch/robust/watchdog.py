"""Bounded retry/backoff around a host-device sync point.

Counterpart of ``repro/robust/watchdog.py`` (pure Python, copied).  The
serving engine's device-resident tick has exactly one blocking wait per
tick (``Engine._fetch``: the host waits for the tick's emitted tokens).  A
wedged device turns that into an unbounded hang.  ``watch`` puts a timeout
on the *wait*, not on the work: the function runs once in a daemon thread,
and on each timeout expiry a ``sync_timeout`` degradation event is recorded
and the wait starts again with exponential backoff.  Only after the retry
budget is spent does it raise :class:`WatchdogTimeout`.

``fn`` is never invoked again: a device sync is not idempotent (a second
wait on a wedged device stacks a second hang), so the retries extend
patience, observably, instead of duplicating work.
"""
from __future__ import annotations

import threading

from repro_torch.robust import events

__all__ = ["WatchdogTimeout", "watch"]


class WatchdogTimeout(TimeoutError):
    """A watched call failed to complete within the retry/backoff budget."""


def watch(fn, *, timeout_s: float, retries: int = 2, backoff: float = 2.0,
          component: str = "watchdog"):
    """Run ``fn()`` once, waiting at most ``timeout_s`` (then ``timeout_s *
    backoff``, ... for ``retries`` extra waits).  Returns ``fn``'s result or
    re-raises its exception.  Each expired wait records a ``sync_timeout``
    event; exhausting the budget raises :class:`WatchdogTimeout`.

    ``timeout_s <= 0`` disables the watchdog and calls ``fn`` inline.
    """
    if timeout_s <= 0:
        return fn()

    box: dict = {}
    done = threading.Event()

    def _run() -> None:
        try:
            box["result"] = fn()
        except BaseException as exc:  # propagate to the caller below
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(target=_run, daemon=True,
                              name=f"watchdog:{component}")
    thread.start()

    wait = float(timeout_s)
    total = 0.0
    for attempt in range(retries + 1):
        if done.wait(wait):
            break
        total += wait
        events.record(
            component=component, reason="sync_timeout",
            detail=(f"wait {attempt + 1}/{retries + 1} expired after "
                    f"{wait:.3g}s (total {total:.3g}s)"))
        wait *= backoff
    else:
        raise WatchdogTimeout(
            f"{component}: no completion after {retries + 1} waits "
            f"({total:.3g}s total); device sync presumed wedged")

    if "error" in box:
        raise box["error"]
    return box["result"]
