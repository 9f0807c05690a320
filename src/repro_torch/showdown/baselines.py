"""External cache baselines: cachetools behind a global lock, and a
lock-striped pure-Python k-way cache (the paper's design, host-side).

Counterpart of ``repro/showdown/baselines.py``, in pure Python as there
(the port keeps its own copy; no module of the reference is imported).

Both expose one method, ``access(key) -> bool`` (True = hit): look the key
up and insert it on a miss — the same get-or-allocate transaction the
torch/cuda ``access`` paths perform per request.  Thread safety is part of
the contract: the harness hammers one shared instance from N threads.

Why these two baselines (DESIGN.md §12):

  * ``CachetoolsCache`` is the production stand-in.  cachetools is the
    standard Python caching library; it is documented as not thread-safe,
    and the prescribed concurrent idiom is a single lock around every
    operation — so its scaling curve shows what a monolithic-lock cache
    does as threads are added (the paper's Fig. 1 left half).
  * ``LockStripedKWay`` holds everything about our design that survives in
    pure Python — same set-index hash, same k-way sets, same LRU/LFU
    victim rule — but with one lock per set instead of one per cache.  It
    isolates the *structural* benefit of limited associativity (contention
    splits across sets) from the vectorization the torch/cuda paths add.
"""
from __future__ import annotations

import threading

try:
    import cachetools
    HAVE_CACHETOOLS = True
except ImportError:                           # not installed: rows skip
    cachetools = None
    HAVE_CACHETOOLS = False

#: murmur3 fmix32 / xxhash constants — bit-identical to
#: ``repro_torch/core/hashing.py``'s hash_u32 so the striped baseline distributes keys to sets exactly like
#: the device paths do.
_PRIME1 = 0x9E3779B1
_PRIME2 = 0x85EBCA77
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF
_EMPTY_KEY = 0xFFFFFFFF
_HASH_SEED = 0x51CA                           # KWayConfig.seed default

_MISS = object()


def hash_u32_host(key: int, seed: int = _HASH_SEED) -> int:
    """Pure-int ``hashing.hash_u32`` (bit-identical, see tests)."""
    x = ((key & _MASK) + seed * _PRIME1) & _MASK
    x = (x * _PRIME2) & _MASK
    x ^= x >> 16
    x = (x * _C1) & _MASK
    x ^= x >> 13
    x = (x * _C2) & _MASK
    x ^= x >> 16
    return x


class CachetoolsCache:
    """``cachetools.LRUCache``/``LFUCache`` + the documented global lock."""

    name = "cachetools"

    def __init__(self, capacity: int, policy: str = "lru"):
        if not HAVE_CACHETOOLS:
            raise ImportError(
                "cachetools is not installed — pip install -r "
                "requirements-dev.txt (the showdown harness benchmarks "
                "against it)")
        cls = {"lru": cachetools.LRUCache, "lfu": cachetools.LFUCache}
        try:
            self._cache = cls[policy](maxsize=capacity)
        except KeyError:
            raise ValueError(
                f"unknown cachetools policy {policy!r}; expected "
                f"{sorted(cls)}") from None
        self._lock = threading.Lock()

    def access(self, key: int) -> bool:
        with self._lock:
            if self._cache.get(key, _MISS) is not _MISS:
                return True
            self._cache[key] = key
            return False

    def __len__(self) -> int:
        return len(self._cache)


class LockStripedKWay:
    """Pure-Python k-way set-associative cache, one lock per set.

    Per set: a dict of at most ``ways`` entries mapping key -> metadata
    (monotonic per-set access time for LRU, hit count for LFU); the victim
    is the min-metadata entry, empty ways first — the sequential (B=1)
    semantics of ``repro_torch/core/kway.access``.  Keys are set-indexed with the same
    seeded avalanche hash as the device paths and the EMPTY_KEY sentinel is
    folded identically, so at matched geometry this cache is the host-side
    twin of a ``KWayConfig(num_sets, ways)`` replay.
    """

    name = "striped"

    def __init__(self, num_sets: int, ways: int, policy: str = "lru",
                 seed: int = _HASH_SEED):
        if num_sets & (num_sets - 1):
            raise ValueError(f"num_sets must be a power of two, "
                             f"got {num_sets}")
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown striped policy {policy!r}; expected "
                             "['lfu', 'lru']")
        self.num_sets, self.ways, self.policy = num_sets, ways, policy
        self._seed = seed
        self._sets: list[dict] = [{} for _ in range(num_sets)]
        self._locks = [threading.Lock() for _ in range(num_sets)]
        self._clocks = [0] * num_sets         # per-set logical time (LRU)

    def _set_index(self, key: int) -> int:
        return hash_u32_host(key, self._seed) & (self.num_sets - 1)

    def access(self, key: int) -> bool:
        key &= _MASK
        if key == _EMPTY_KEY:
            key = 0xFFFFFFFE                  # hashing.sanitize_keys fold
        s = self._set_index(key)
        lru = self.policy == "lru"
        with self._locks[s]:
            d = self._sets[s]
            self._clocks[s] += 1
            now = self._clocks[s]
            meta = d.get(key)
            if meta is not None:
                d[key] = now if lru else meta + 1
                return True
            if len(d) >= self.ways:
                victim = min(d, key=d.get)    # min metadata == LRU/LFU rule
                del d[victim]
            d[key] = now if lru else 1
            return False

    def __len__(self) -> int:
        return sum(len(d) for d in self._sets)


def make_baseline(lib: str, capacity: int, policy: str, ways: int = 8):
    """Factory keyed by the figure's library names.

    ``lib``: "cachetools" (full-associativity LRU/LFU + global lock) or
    "striped" (k-way, ``ways`` ways, one lock per set).  ``capacity`` is
    total entries for both.
    """
    if lib == "cachetools":
        return CachetoolsCache(capacity, policy=policy)
    if lib == "striped":
        if capacity % ways:
            raise ValueError(f"capacity {capacity} not divisible by "
                             f"ways={ways}")
        return LockStripedKWay(capacity // ways, ways, policy=policy)
    raise ValueError(f"unknown baseline library {lib!r}; expected "
                     "['cachetools', 'striped']")
