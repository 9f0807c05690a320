"""Core library of the port: the k-way cache and its trace replay.

Public API:
    KWayConfig, KWayState, make_cache, get, put, access, peek_victims
    Policy             — LRU / LFU / FIFO / RANDOM / HYPERBOLIC
    TinyLFUConfig, TinyLFUState — TinyLFU admission (core/admission.py)
    HierarchyConfig, HierState  — the L1-over-L2 hierarchy
                                  (core/hierarchy.py)
    CacheBackend layer — backend.{make_backend, available_backends}
                         ("torch" | "cuda" | "ref", one contract)
    simulate.replay, simulate.replay_batched — trace replay
    traces.generate    — synthetic workload families; trace_io ingests
                         ARC/LIRS and Twitter CSV files as families
"""
from repro_torch.core.admission import TinyLFUConfig, TinyLFUState  # noqa: F401
from repro_torch.core.backend import (  # noqa: F401
    CacheBackend,
    available_backends,
    make_backend,
)
from repro_torch.core.hierarchy import HierarchyConfig, HierState  # noqa: F401
from repro_torch.core.kway import (  # noqa: F401
    KWayConfig,
    KWayState,
    access,
    get,
    make_cache,
    peek_victims,
    put,
)
from repro_torch.core.policies import Policy  # noqa: F401
