"""Threaded replay harness for the external cache baselines.

Counterpart of ``repro/showdown/harness.py``: its watchdog is
``repro_torch/robust/watchdog.py`` and its timer
``repro_torch/eval/timing.py``.

Methodology (DESIGN.md §12): the paper's throughput figures give every
thread its own request loop against one shared cache and report aggregate
requests/second.  ``replay_threaded`` reproduces that — the trace is split
into ``threads`` contiguous slices, each worker replays its slice against
the shared cache counting hits locally, and one replay completes when every
worker has drained its slice.  The thread pool is created once per
configuration and reused across timing repetitions, so thread spawn cost
stays out of the steady-state window (the same reason the device paths keep
kernel builds in the discarded warmup).

Hit ratios under concurrent interleaving are nondeterministic (that is the
point of the paper's racy-access model), so throughput rows are
``comparable: false``; the deterministic parity records the CI gate checks
come from ``hit_ratio`` — a single-threaded replay of the same trace on a
fresh cache.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["replay_threaded", "hit_ratio", "ThreadedReplay"]


def _worker(cache, keys) -> int:
    access = cache.access                    # one attr lookup per slice
    hits = 0
    for k in keys:
        if access(k):
            hits += 1
    return hits


class ThreadedReplay:
    """One (cache, trace, threads) replay bound to a reusable pool.

    Calling the instance replays the WHOLE trace once and returns the total
    hit count (a Python int — already synced, so the timing helpers'
    ``block`` is a no-op).  Use as a context manager or call
    ``close()`` to drop the pool.

    ``timeout_s > 0`` arms a watchdog over the worker joins: each expired
    wait (growing by ``backoff``) records a degradation event, and after
    ``retries`` extra waits the replay raises ``WatchdogTimeout`` instead
    of hanging the harness on a deadlocked contender cache.
    """

    def __init__(self, cache, trace: np.ndarray, threads: int, *,
                 timeout_s: float = 0.0, retries: int = 2,
                 backoff: float = 2.0):
        if threads < 1:
            raise ValueError(f"threads must be >= 1, got {threads}")
        self.cache = cache
        self.threads = threads
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff = backoff
        # Python-int key lists, pre-split: uint32->int conversion cost is
        # paid once here, not inside the timed region.
        keys = [int(k) for k in np.asarray(trace, np.uint32)]
        bound = -(-len(keys) // threads)
        self._slices = [keys[i * bound:(i + 1) * bound]
                        for i in range(threads)]
        self._slices = [s for s in self._slices if s]
        self._pool = (ThreadPoolExecutor(max_workers=threads)
                      if threads > 1 else None)

    def __call__(self) -> int:
        if self.timeout_s > 0:
            from repro_torch.robust.watchdog import watch
            return watch(self._replay_once, timeout_s=self.timeout_s,
                         retries=self.retries, backoff=self.backoff,
                         component="showdown.replay")
        return self._replay_once()

    def _replay_once(self) -> int:
        if self._pool is None:               # no pool round trip at T=1
            return _worker(self.cache, self._slices[0])
        futures = [self._pool.submit(_worker, self.cache, s)
                   for s in self._slices]
        return sum(f.result() for f in futures)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay_threaded(cache, trace: np.ndarray, threads: int,
                    iters: int = 3, warmup: int = 1) -> dict:
    """Steady-state throughput of one cache under ``threads`` workers.

    Runs ``warmup`` discarded replays (cache warm-up — the steady state of
    a cache benchmark is the warmed cache, matching the device paths'
    warm-state timing) then ``iters`` timed replays of the whole trace.
    Returns ``{"p50", "p90", "req_s_p50", "req_s_p90", "hits_last", "n",
    "iters", "reps_discarded"}``.
    """
    from repro_torch.eval.timing import time_replay_percentiles

    n = len(trace)
    with ThreadedReplay(cache, trace, threads) as replay:
        stats = time_replay_percentiles(replay, iters=iters, warmup=warmup)
        hits_last = replay()                 # warmed-state hit count
    return {
        "p50": stats["p50"], "p90": stats["p90"],
        "req_s_p50": n / stats["p50"], "req_s_p90": n / stats["p90"],
        "hits_last": int(hits_last), "n": n,
        "iters": stats["iters"], "reps_discarded": stats["reps_discarded"],
    }


def hit_ratio(cache, trace: np.ndarray) -> float:
    """Deterministic single-threaded hit ratio of a FRESH cache over the
    trace — the comparable parity record the showdown gate checks."""
    hits = _worker(cache, [int(k) for k in np.asarray(trace, np.uint32)])
    return hits / len(trace)
