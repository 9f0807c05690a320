"""ttft_p90_ms: the 90th percentile, over every request whose first token
reached the host in the window, of the time from ``submit`` to that token
(host clock), in the serving cells.

A per-layer reading and not an end-to-end one: the closed loop keeps the
engine's slots full, so the tail swings with one slow wave of admissions
(PERF.md section 2), and tokens/s is the end-to-end metric."""
import numpy as np


def read(run):
    t = run.records.get("ttft")
    if t is None or not len(t):
        return None
    return float(np.percentile(t, 90)) * 1e3
