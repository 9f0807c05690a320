"""tick_gap_share: of the device time from the first profiler-free tick's
start to the last one's end, the share in which the engine's stream waits
for the host between ticks: the sum of the ticks' ``gap_ms`` (the previous
tick's end event to this tick's start event) over that sum plus their
``tick_ms`` (start event to ``_done``), in the serving cells
(``serve.step`` records, ``serve/engine.py``).  No profiler runs in those
ticks, so the gap is the host's own."""
from bench import program


def read(run):
    pairs = [(s.attrs.get("gap_ms"), s.attrs.get("tick_ms"))
             for s, _ in program.serve_ticks(run) or ()]
    pairs = [(g, t) for g, t in pairs if g is not None and t is not None]
    gap = sum(g for g, _ in pairs)
    busy = sum(t for _, t in pairs)
    return 100.0 * gap / (gap + busy) if pairs and gap + busy > 0 else None
