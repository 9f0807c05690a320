"""replay_bucketing_share: of the device time that ``CacheBackend.replay``
launches, the share that is not kernel 3 itself (the routing's torch ops,
the bucketing kernels and the copies of the state's lanes), in the replay
cells.  Device ops are tied to the replay call by their launch's
correlation id.  Not measured where the trace ties another number of
kernel-3 records to the replay calls than replays the window ran."""
KERNEL = "owners_kernel"


def read(run):
    tl = run.timeline
    if tl is None or "replays" not in run.records:
        return None
    if tl.count(KERNEL, span="replay") != run.records["replays"]:
        return None
    total = tl.seconds(span="replay")
    if total <= 0:
        return None
    return 100.0 * (total - tl.seconds(KERNEL, span="replay")) / total
