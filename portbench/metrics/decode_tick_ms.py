"""decode_tick_ms: the mean host-clock milliseconds of the window's
``Engine.step()`` calls that ran the decode graph."""


def read(run):
    t = [dt for kind, dt in run.records.get("steps", ()) if kind == "decode"]
    return 1e3 * sum(t) / len(t) if t else None
