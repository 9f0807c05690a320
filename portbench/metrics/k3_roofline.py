"""k3_roofline: kernel 3's share of its bytes bound, in the replay cells.

The bound of one replay: the trace's keys read once (4 B a request), the
whole cache state (five int32 lanes a slot) read once and written once,
and the per-chunk hit and eviction counters written once (8 B a chunk), at
the card's HBM rate.  Over the traced window: that bound times the replays,
over kernel 3's device time (``owners_kernel``) from the trace.  Not
measured where the trace holds another number of kernel-3 records than
replays the window ran (the profiler dropped some).
"""
from bench.peaks import peak

KERNEL = "owners_kernel"
STATE_LANES = 5


def replay_bytes(requests: int, capacity: int, steps: int) -> int:
    return 4 * requests + 2 * STATE_LANES * 4 * capacity + 8 * steps


def read(run):
    tl, r = run.timeline, run.records
    bw = peak(run.kind, "hbm_byte_s")
    if tl is None or bw is None or "replays" not in r:
        return None
    n = tl.count(KERNEL)
    if n == 0 or n != r["replays"]:
        return None
    bound_s = n * replay_bytes(r["requests"], r["capacity"], r["steps"]) / bw
    return 100.0 * bound_s / tl.seconds(KERNEL)
