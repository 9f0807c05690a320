"""prefix_hit_share: of the prompt blocks the engine looked up in the
window, the share its prefix cache served (``Engine.stats``:
``prefix_hits / prefix_lookups`` over the window)."""


def read(run):
    r = run.records
    if "stats1" not in r:
        return None
    hits = r["stats1"]["prefix_hits"] - r["stats0"]["prefix_hits"]
    looks = r["stats1"]["prefix_lookups"] - r["stats0"]["prefix_lookups"]
    return 100.0 * hits / looks if looks else None
