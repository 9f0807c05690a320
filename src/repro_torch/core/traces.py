"""Synthetic trace families standing in for the paper's workload suite.

The paper evaluates on Wikipedia, Sprite, multi1-3, OLTP, DS1, S1/S3, P8-14,
F1/F2 and W2/W3 traces — none redistributable offline.  Each family below is
parameterized to match a *class* of those workloads (DESIGN.md §6):

  zipf            — web/CDN-like skewed popularity (wiki*, S*, W*)
  zipf_shift      — popularity drifts in phases (multi1-3 mixtures)
  scan_loop       — cyclic scans larger than the cache (glimpse/postgres;
                    the classic LRU-killer)
  recency         — stack-distance-driven, strongly recency-biased (sprite,
                    filesystem traces)
  oltp_mix        — skewed working set + uniform background writes (OLTP,
                    F1/F2 financial)
  ttl_churn       — TTL-bearing memcached-style mix (DESIGN.md §15): a
                    Zipf-popular core with long TTLs over a churning
                    uniform minority with short TTLs.  ``generate`` serves
                    the keys; ``generate_ttl`` returns ``(keys, ttls)``.

Generators are seeded numpy (host side — traces are inputs, not model state).

Counterpart of ``repro/core/traces.py``: the same generators with the
same rng call order, so a seed gives the same trace in both packages.
``core/trace_io.py`` registers ingested traces through ``register_family``.
"""
from __future__ import annotations

import inspect

import numpy as np

__all__ = ["generate", "generate_ttl", "register_family",
           "unregister_family", "FAMILIES", "TTL_FAMILIES"]


def _zipf_catalog(rng: np.random.Generator, n: int, catalog: int, alpha: float):
    ranks = np.arange(1, catalog + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    # Random identity permutation so key id != popularity rank.
    ident = rng.permutation(catalog).astype(np.uint32)
    draws = rng.choice(catalog, size=n, p=p)
    return ident[draws]


def zipf(rng, n, catalog=1 << 16, alpha=0.9):
    return _zipf_catalog(rng, n, catalog, alpha)


def zipf_shift(rng, n, catalog=1 << 16, alpha=0.9, phases=4):
    """Popularity permutation re-drawn each phase (multi* style)."""
    per = n // phases
    parts = []
    for p in range(phases):
        m = per if p < phases - 1 else n - per * (phases - 1)
        parts.append(_zipf_catalog(rng, m, catalog, alpha) + np.uint32(p * catalog))
    return np.concatenate(parts)


def scan_loop(rng, n, working=1 << 14, noise=0.1, catalog=1 << 20):
    """Sequential loop over `working` keys with `noise` random accesses."""
    base = np.arange(n, dtype=np.uint32) % np.uint32(working)
    mask = rng.random(n) < noise
    base[mask] = rng.integers(0, catalog, size=mask.sum(), dtype=np.uint32)
    return base


def recency(rng, n, catalog=1 << 18, theta=0.8):
    """Stack-distance model: each access re-references a recently used key
    with probability theta (distance ~ geometric), else a fresh key."""
    window = 4096
    recent = np.full(window, 0, dtype=np.uint32)
    out = np.empty(n, dtype=np.uint32)
    head = 0
    fresh = iter(rng.integers(0, catalog, size=n, dtype=np.uint32))
    reuse = rng.random(n) < theta
    dist = rng.geometric(0.02, size=n) % window
    for i in range(n):
        if reuse[i] and i > 0:
            # Only the most recent min(i, window) ring slots have been
            # written; an unclamped distance wraps into unwritten zero slots
            # and inflates key 0's popularity for the whole warm-up window.
            k = recent[(head - 1 - dist[i] % min(i, window)) % window]
        else:
            k = next(fresh)
        out[i] = k
        recent[head % window] = k
        head += 1
    return out


def oltp_mix(rng, n, catalog=1 << 17, alpha=1.1, hot_frac=0.7):
    hot = _zipf_catalog(rng, n, max(1024, catalog // 64), alpha)
    cold = rng.integers(0, catalog, size=n, dtype=np.uint32)
    take_hot = rng.random(n) < hot_frac
    return np.where(take_hot, hot, cold + np.uint32(1 << 24)).astype(np.uint32)


def ttl_churn(rng, n, catalog=1 << 12, alpha=0.9, hot_ttl=4096,
              churn_ttl=48, churn_frac=0.3):
    """Memcached-style TTL workload (DESIGN.md §15): a Zipf-popular core
    whose entries live long (``hot_ttl`` clock ticks) interleaved with a
    churning uniform minority (fraction ``churn_frac``, disjoint key range)
    whose entries expire almost immediately (``churn_ttl``).  A cache that
    never reclaims expired lanes drowns in dead churn entries; one that
    prefers expired victims keeps the hot core resident.

    Returns ``(keys, ttls)`` — uint32 keys and int32 per-request TTLs.
    Callable through ``generate`` (keys only) or ``generate_ttl`` (both).
    """
    hot = _zipf_catalog(rng, n, catalog, alpha)
    cold = rng.integers(0, catalog, size=n, dtype=np.uint32)
    churn = rng.random(n) < churn_frac
    keys = np.where(churn, cold + np.uint32(catalog), hot).astype(np.uint32)
    ttls = np.where(churn, churn_ttl, hot_ttl).astype(np.int32)
    return keys, ttls


FAMILIES = {
    "zipf": zipf,
    "zipf_shift": zipf_shift,
    "scan_loop": scan_loop,
    "recency": recency,
    "oltp_mix": oltp_mix,
    "ttl_churn": lambda rng, n, **kw: ttl_churn(rng, n, **kw)[0],
}

#: TTL-bearing families: ``fn(rng, n, **kw) -> (keys uint32, ttls int32)``.
#: ``generate()`` serves the key stream of such a family (the keys-only
#: wrapper above); ``generate_ttl()`` returns both streams from ONE rng
#: draw, so ``generate_ttl(f, n, seed)[0] == generate(f, n, seed)``.
TTL_FAMILIES = {
    "ttl_churn": ttl_churn,
}

#: the synthetic families above are permanent; runtime registrations
#: (ingested traces) may shadow nothing in this set
_BUILTINS = frozenset(FAMILIES)


def register_family(name: str, fn) -> None:
    """Register a runtime trace family (``fn(rng, n, **kw) -> ndarray``).
    Re-registering a runtime family replaces it; the built-in synthetic
    families cannot be shadowed."""
    if name in _BUILTINS:
        raise ValueError(
            f"cannot register {name!r}: it would shadow the built-in "
            f"synthetic family of the same name")
    FAMILIES[name] = fn


def unregister_family(name: str) -> None:
    """Remove a runtime-registered family (built-ins cannot be removed),
    with a matching runtime ``TTL_FAMILIES`` entry."""
    if name in _BUILTINS:
        raise ValueError(f"cannot unregister built-in family {name!r}")
    FAMILIES.pop(name, None)
    TTL_FAMILIES.pop(name, None)


def generate(family: str, n: int, seed: int = 0, **kw) -> np.ndarray:
    fn = FAMILIES.get(family)
    if fn is None:
        raise ValueError(
            f"unknown trace family {family!r}; known families: "
            f"{', '.join(sorted(FAMILIES))}")
    params = inspect.signature(fn).parameters
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
        bad = sorted(set(kw) - set(params))
        if bad:
            accepted = sorted(set(params) - {"rng", "n"})
            raise ValueError(
                f"unknown trace kwargs {bad} for family {family!r}; "
                f"accepted: {accepted}")
    rng = np.random.default_rng(seed)
    return fn(rng, n, **kw).astype(np.uint32)


def generate_ttl(family: str, n: int, seed: int = 0, **kw):
    """``(keys, ttls)`` for a TTL-bearing family (``TTL_FAMILIES``).

    The family draws both streams from one seeded rng, so the key stream
    is bit-identical to ``generate(family, n, seed, **kw)`` — a TTL-aware
    replay and a TTL-blind replay of the same family see the same keys.
    """
    fn = TTL_FAMILIES.get(family)
    if fn is None:
        raise ValueError(
            f"unknown TTL trace family {family!r}; known TTL families: "
            f"{', '.join(sorted(TTL_FAMILIES))}")
    rng = np.random.default_rng(seed)
    keys, ttls = fn(rng, n, **kw)
    return keys.astype(np.uint32), np.asarray(ttls, np.int32)
