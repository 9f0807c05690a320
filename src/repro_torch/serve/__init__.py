"""Paged-KV serving on a k-way set-associative prefix cache (port).

Public surface: the host-loop :class:`Engine`, its :class:`EngineConfig`
and :class:`Request`.  The reference's device-resident tick (``ServeState``,
``trace_counts``) is not ported yet.
"""
from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineConfig,
    Request,
)
