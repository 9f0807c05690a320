"""k3_chain_ns: kernel 3's device nanoseconds per lane of the longest chain
a warp walks: the window's ``replay.kernel`` spans (a timing event pair
around each launch, ``kernels/replay.py``) over the ``replay.chain_lanes``
counter (each launch's largest owner bucket, added on the device), in the
replay cells.  None where the form does not bucket (no span)."""
from bench import program


def read(run):
    ms = [x for s in program.spans("replay.kernel") or ()
          for x in s.device_ms]
    lanes = program.counters().get("replay.chain_lanes")
    if not ms or not lanes:
        return None
    return sum(ms) * 1e6 / lanes
