"""Real-trace ingestion — public cache traces as drop-in trace families.

Counterpart of ``repro/core/trace_io.py`` (numpy only), kept as the port's
own copy so that ``repro_torch`` never imports ``repro``: the same parsers,
fingerprint contract and registry hook, so an ingested file gives the same
keys, TTLs and fingerprint in both packages.

The paper evaluates on public traces (Wikipedia, OLTP, F1/F2, multi*, ...)
that ship in two dominant on-disk shapes.  This module parses both into the
same ``np.uint32`` key arrays the synthetic families in ``core/traces.py``
emit, so a downloaded trace file drops into every existing sweep, gate and
golden-trace workflow unchanged:

  * ``"arc"``  — ARC/LIRS-style plain text (``.trace``/``.lirs``): one
    decimal block id per line.  Extra whitespace-separated columns after the
    key (the 4-column ARC header form ``start count ignored id``) are
    tolerated; the first field is the key.  Numeric ids are used directly
    (mod 2^32) — block-id locality is part of the workload.
  * ``"csv"``  — Twitter/Memcached-style CSV with op/key/size columns.
    A header row naming ``op``/``key`` (any column order, extra columns
    ignored) is auto-detected; headerless files are read positionally as
    ``op,key[,size[,ttl]]``.  Keys are opaque strings and are
    **fingerprint-hashed** into the uint32 key space (see
    ``fingerprint_keys``).

TTL columns (DESIGN.md §15): pass ``with_ttl=True`` (or
``register_trace(..., ttl=True)``) to surface a per-request TTL stream
alongside the keys.  In CSV the TTL is the header-named ``ttl`` column, or
positional column 3 for headerless files; rows without the column (and the
op-less ARC format entirely) default to TTL ``0`` — which the replay
layers map to "never expires", so a TTL-oblivious file replayed through a
TTL-aware path is bit-identical to the TTL-free replay.

Key-space fingerprint contract: a string key maps to
``fmix32(FNV1a_32(utf8(key)))`` — deterministic across runs/platforms, full
avalanche (murmur3 finalizer, the same mixer ``core/hashing.py`` uses), and
folded away from the cache's EMPTY_KEY sentinel.  Collisions are the usual
birthday bound (~n^2/2^33); at trace sizes up to a few million keys this
perturbs hit ratios far below the gate tolerances.

Reads are streaming/chunked (``iter_trace_chunks``): a multi-GB trace never
needs to fit in memory as text — only the uint32 key array does.

``register_trace`` drops an ingested file into the ``traces.generate()``
registry: ``generate(name, n)`` serves the first ``n`` requests (tiling the
file if ``n`` exceeds it), which is exactly the contract every sweep and
replay entry point already assumes.
"""
from __future__ import annotations

import csv as _csv
import os

import numpy as np

from repro_torch.core import traces

__all__ = ["load_trace", "iter_trace_chunks", "fingerprint_keys",
           "trace_fingerprint", "register_trace", "unregister_trace",
           "detect_format", "register_fixture_traces", "fixture_dir",
           "FIXTURE_TRACES"]

#: murmur3 fmix32 constants — the same avalanche mixer as core/hashing.py.
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF
_EMPTY_KEY = 0xFFFFFFFF

#: default read-op set for the ``ops=`` filter ("reads only" ingestion);
#: ``ops=None`` keeps every row — our caches model key residency, and a
#: SET on a missing key allocates just like a GET-miss does.
READ_OPS = frozenset({"get", "gets", "read"})


def _fmix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * _C1) & _MASK
    x ^= x >> 13
    x = (x * _C2) & _MASK
    x ^= x >> 16
    return x


def _sanitize(k: int) -> int:
    """Fold the EMPTY_KEY sentinel exactly like hashing.sanitize_keys."""
    k &= _MASK
    return 0xFFFFFFFE if k == _EMPTY_KEY else k


def fingerprint_keys(keys) -> np.ndarray:
    """Map opaque string keys into the uint32 key space (the contract the
    module docstring documents).  -> uint32 [len(keys)]."""
    out = np.empty(len(keys), np.uint32)
    for i, key in enumerate(keys):
        h = _FNV_OFFSET
        for b in key.encode("utf-8"):
            h = ((h ^ b) * _FNV_PRIME) & _MASK
        out[i] = _sanitize(_fmix32_int(h))
    return out


def trace_fingerprint(keys: np.ndarray) -> str:
    """Order-sensitive digest of a key array — provenance for artifacts.

    FNV-1a folded over the raw little-endian bytes, avalanche-finished;
    eight hex chars.  Two ingestions of the same file always agree; any
    reordering, truncation or parse change shows up immediately.
    """
    h = _FNV_OFFSET
    for b in np.ascontiguousarray(keys, np.uint32).tobytes():
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return f"{_fmix32_int(h):08x}"


def detect_format(path: str) -> str:
    """File-extension format sniff: ``.csv`` -> "csv", else "arc"."""
    return "csv" if os.path.splitext(path)[1].lower() == ".csv" else "arc"


# ---------------------------------------------------------------------------
# parsers (streaming)
# ---------------------------------------------------------------------------

def _iter_arc(path: str, chunk: int):
    buf = []
    n_seen = 0
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            fields = line.split()
            if not fields:
                continue                     # blank lines are separators
            try:
                key = int(fields[0], 10)
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: malformed ARC/LIRS trace line "
                    f"{line.strip()!r} — the first field must be a decimal "
                    "key") from None
            buf.append(_sanitize(key))
            n_seen += 1
            if len(buf) >= chunk:
                yield np.asarray(buf, np.uint32)
                buf = []
    if buf:
        yield np.asarray(buf, np.uint32)
    if n_seen == 0:
        raise ValueError(f"{path}: empty trace (no requests parsed)")


def _header_columns(row) -> dict | None:
    """Map column name -> index when ``row`` is a header row, else None."""
    names = [c.strip().lower() for c in row]
    if "op" in names and "key" in names:
        return {name: i for i, name in enumerate(names)}
    return None


#: positional TTL column for headerless CSV rows (``op,key[,size[,ttl]]``)
_TTL_POS = 3


def _iter_csv(path: str, chunk: int, ops, with_ttl: bool = False):
    ops = None if ops is None else frozenset(o.lower() for o in ops)
    buf: list[str] = []
    tbuf: list[int] = []
    n_seen = 0

    def flush():
        arr = fingerprint_keys(buf)
        buf.clear()
        if not with_ttl:
            return arr
        tarr = np.asarray(tbuf, np.int32)
        tbuf.clear()
        return arr, tarr

    with open(path, newline="") as f:
        reader = _csv.reader(f)
        cols = {"op": 0, "key": 1}
        ttl_col = _TTL_POS
        first = True
        for lineno, row in enumerate(reader, start=1):
            if not row or all(not c.strip() for c in row):
                continue
            if first:
                first = False
                named = _header_columns(row)
                if named is not None:
                    cols = named
                    # header-named ttl column wins; a header without one
                    # means the file has no TTLs (don't misread a stray
                    # positional column as deadlines)
                    ttl_col = named.get("ttl")
                    continue                 # header row consumed
            if len(row) <= max(cols["op"], cols["key"]):
                raise ValueError(
                    f"{path}:{lineno}: malformed CSV trace row {row!r} — "
                    f"need op/key columns at indices "
                    f"{cols['op']}/{cols['key']}")
            op = row[cols["op"]].strip().lower()
            key = row[cols["key"]].strip()
            if not op or not key:
                raise ValueError(
                    f"{path}:{lineno}: malformed CSV trace row {row!r} — "
                    "empty op or key field")
            n_seen += 1
            if ops is not None and op not in ops:
                continue
            buf.append(key)
            if with_ttl:
                ttl = 0                      # absent column -> never expires
                if ttl_col is not None and len(row) > ttl_col:
                    field = row[ttl_col].strip()
                    if field:
                        try:
                            ttl = int(field, 10)
                        except ValueError:
                            raise ValueError(
                                f"{path}:{lineno}: malformed CSV trace row "
                                f"{row!r} — ttl column must be a decimal "
                                f"integer, got {field!r}") from None
                tbuf.append(ttl)
            if len(buf) >= chunk:
                yield flush()
    if buf:
        yield flush()
    if n_seen == 0:
        raise ValueError(f"{path}: empty trace (no requests parsed)")


def iter_trace_chunks(path: str, fmt: str | None = None,
                      chunk: int = 1 << 16, ops=None,
                      with_ttl: bool = False):
    """Stream a trace file as uint32 key-array chunks (<= ``chunk`` keys).

    ``fmt``: "arc" | "csv" | None (sniff from the extension).  ``ops``
    filters CSV rows to the given operation names (e.g. ``READ_OPS``);
    ignored for the op-less ARC format.  ``with_ttl`` yields
    ``(keys, ttls)`` pairs instead (int32 TTLs; see the module docstring
    for the column contract — ARC traces yield all-zero TTLs).
    """
    fmt = fmt or detect_format(path)
    if fmt == "arc":
        it = _iter_arc(path, chunk)
        if not with_ttl:
            return it
        return ((arr, np.zeros(len(arr), np.int32)) for arr in it)
    if fmt == "csv":
        return _iter_csv(path, chunk, ops, with_ttl=with_ttl)
    raise ValueError(f"unknown trace format {fmt!r}; expected 'arc' or 'csv'")


def load_trace(path: str, fmt: str | None = None, limit: int | None = None,
               ops=None, with_ttl: bool = False):
    """Parse a whole trace file -> uint32 key array (see module docstring).

    ``limit`` stops the streaming read after that many requests — a cheap
    way to sample the head of a multi-GB trace.  ``with_ttl`` returns
    ``(keys, ttls)`` (int32 TTLs, 0 = never expires) instead of bare keys.
    """
    parts, tparts, total = [], [], 0
    for item in iter_trace_chunks(path, fmt=fmt, ops=ops, with_ttl=with_ttl):
        arr, tarr = item if with_ttl else (item, None)
        parts.append(arr)
        if with_ttl:
            tparts.append(tarr)
        total += len(arr)
        if limit is not None and total >= limit:
            break
    if not parts:
        raise ValueError(
            f"{path}: no requests survived the op filter {sorted(ops)!r}")
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    out = out[:limit] if limit is not None else out
    if not with_ttl:
        return out
    tout = tparts[0] if len(tparts) == 1 else np.concatenate(tparts)
    return out, tout[:len(out)]


# ---------------------------------------------------------------------------
# traces.generate() registry integration
# ---------------------------------------------------------------------------

def register_trace(name: str, path: str, fmt: str | None = None,
                   ops=None, limit: int | None = None,
                   ttl: bool = False) -> str:
    """Register a trace file as a ``traces.generate()`` family.

    The file is parsed lazily on first use and memoized.  The family
    callable ignores the rng (real traces are fixed request streams — the
    seed only matters for synthetic families) and serves the first ``n``
    requests, tiling the file when ``n`` exceeds its length, so ingested
    traces satisfy the same ``generate(family, n)`` contract as every
    synthetic family.  Returns ``name``.

    ``ttl=True`` additionally parses the file's TTL column (module
    docstring) and registers the trace in ``traces.TTL_FAMILIES``:
    ``traces.generate_ttl(name, n)`` then serves the ``(keys, ttls)``
    pair, tiled in lockstep, so a TTL-bearing fixture replays through
    ``simulate.replay_batched(..., ttls=...)`` unchanged.
    """
    cache: dict = {}

    def _load():
        if "keys" not in cache:
            if ttl:
                cache["keys"], cache["ttls"] = load_trace(
                    path, fmt=fmt, limit=limit, ops=ops, with_ttl=True)
            else:
                cache["keys"] = load_trace(path, fmt=fmt, limit=limit,
                                           ops=ops)

    def _tile(arr, n):
        if n <= len(arr):
            return arr[:n].copy()
        reps = -(-n // len(arr))
        return np.tile(arr, reps)[:n]

    def ingested(rng, n):
        _load()
        return _tile(cache["keys"], n)

    ingested.__name__ = f"ingested_{name}"
    ingested.path = path
    traces.register_family(name, ingested)
    if ttl:
        def ingested_ttl(rng, n):
            _load()
            return _tile(cache["keys"], n), _tile(cache["ttls"], n)

        ingested_ttl.__name__ = f"ingested_{name}_ttl"
        ingested_ttl.path = path
        traces.TTL_FAMILIES[name] = ingested_ttl
    return name


def unregister_trace(name: str) -> None:
    """Remove a ``register_trace`` entry from the family registry."""
    traces.unregister_family(name)


#: committed fixture traces (tests/fixtures/*) registered by
#: ``register_fixture_traces`` — name -> filename.  ``lirs_two_pools`` is
#: the deterministic LIRS-style loop workload the hierarchy and showdown
#: sweeps use as their "real trace" family (see
#: tests/fixtures/make_lirs_two_pools.py for provenance);
#: ``sample_twitter_ttl`` is the pinned TTL-column CSV exercising the
#: DESIGN.md §15 ingestion path (registered with ``ttl=True``).
FIXTURE_TRACES = {"lirs_two_pools": "lirs_two_pools.trace",
                  "sample_twitter_ttl": "sample_twitter_ttl.csv"}

#: fixtures whose files carry a TTL column (registered with ``ttl=True``)
_TTL_FIXTURES = frozenset({"sample_twitter_ttl"})


def fixture_dir() -> str:
    """Path of the repo's committed ``tests/fixtures`` directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    # src/repro_torch/core -> repo root is three levels up
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(here))), "tests", "fixtures")


def register_fixture_traces() -> list[str]:
    """Register every committed fixture trace as a ``generate()`` family.

    Idempotent (``register_trace`` overwrites in place); returns the list
    of family names registered.  Benchmarks call this so sweeps can name
    ``lirs_two_pools`` alongside the synthetic families.
    """
    root = fixture_dir()
    names = []
    for name, fname in FIXTURE_TRACES.items():
        path = os.path.join(root, fname)
        if os.path.exists(path):
            names.append(register_trace(name, path,
                                        ttl=name in _TTL_FIXTURES))
    return names
