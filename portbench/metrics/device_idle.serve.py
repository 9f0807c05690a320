"""device_idle.serve: the share of the traced window in which no device
operation runs (the complement of the union of the device intervals), in
the serving cells."""
from bench.trace import idle_share


def read(run):
    return idle_share(run.timeline)
