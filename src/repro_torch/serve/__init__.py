"""Paged-KV serving on a k-way set-associative prefix cache (port).

Public surface: :class:`Engine` (the host loop, or with
``EngineConfig(jitted=True)`` the device-resident tick, captured as CUDA
graphs on the card), its :class:`EngineConfig`, :class:`Request`, the
tick's carry :class:`ServeState`, and ``capture_counts`` /
``reset_capture_counts`` (the counterpart of the reference's
``trace_counts``).
"""
from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineConfig,
    Request,
    ServeState,
    capture_counts,
    reset_capture_counts,
)
