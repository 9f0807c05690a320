"""Trace chunking for batched replay.

Counterpart of ``repro/core/router.py``'s ``pad_chunks``; the set-owner
router of the sharded layer comes with the port of ``core/sharded.py``.
"""
from __future__ import annotations

import numpy as np


def pad_chunks(trace: np.ndarray, batch: int):
    """Chunk a trace for batched replay, padding the trailing
    ``len % batch`` requests into a disabled-lane tail chunk (no request is
    silently dropped) -> (chunks [steps, B] uint32, enabled [steps, B]
    bool), as host arrays.
    """
    trace = np.asarray(trace, np.uint32)
    n = trace.shape[0]
    steps = -(-n // batch)
    padded = np.zeros((steps * batch,), np.uint32)
    padded[:n] = trace
    enabled = np.zeros((steps * batch,), bool)
    enabled[:n] = True
    return padded.reshape(steps, batch), enabled.reshape(steps, batch)
