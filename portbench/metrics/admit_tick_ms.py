"""admit_tick_ms: the mean host-clock milliseconds of the window's
``Engine.step()`` calls that ran the admit graph (``Engine.ticks["admit"]``
advanced); a step ends in the tick's one host sync."""


def read(run):
    t = [dt for kind, dt in run.records.get("steps", ()) if kind == "admit"]
    return 1e3 * sum(t) / len(t) if t else None
