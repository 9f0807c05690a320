"""Showdown harness — production-grade concurrent caches vs our paths.

The paper's headline claim is "throughput improved by up to 5x compared to
production-grade caching libraries"; this package is the external side of
that comparison.  It replays the SAME uint32 key traces that drive the
torch/cuda replay paths through:

  * ``CachetoolsCache``  — ``cachetools.LRUCache``/``LFUCache`` behind one
    global lock under a thread pool: the canonical production Python
    caching idiom (cachetools is not thread-safe; its docs prescribe
    exactly this lock).
  * ``LockStripedKWay``  — a pure-Python reference of the paper's design:
    k-way sets, one lock per set (lock striping), so contention is per-set
    instead of global.  Isolates what limited associativity alone buys a
    host-side implementation.

``harness.replay_threaded`` drives either cache with N worker threads and
the warmup-discard/steady-state protocol of ``eval/timing.py``;
``harness.hit_ratio`` replays single-threaded for the deterministic
hit-ratio parity records the baseline gate checks.
``eval/figures.showdown`` (``python -m repro_torch.eval --fig showdown``)
is the figure's entry point.  Counterpart of ``repro/showdown``, in pure
Python.
"""
from repro_torch.showdown.baselines import (HAVE_CACHETOOLS, CachetoolsCache,
                                            LockStripedKWay, make_baseline)
from repro_torch.showdown.harness import hit_ratio, replay_threaded

__all__ = ["CachetoolsCache", "LockStripedKWay", "make_baseline",
           "replay_threaded", "hit_ratio", "HAVE_CACHETOOLS"]
