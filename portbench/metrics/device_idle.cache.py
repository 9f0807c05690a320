"""device_idle.cache: the share of the traced window in which no device
operation runs (the complement of the union of the device intervals), in
the cache cells."""
from bench.trace import idle_share


def read(run):
    return idle_share(run.timeline)
