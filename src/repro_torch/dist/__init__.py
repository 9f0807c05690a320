"""Distribution helpers: sharding rules for params/inputs/caches as DTensor
placements (counterpart of ``repro/dist``)."""
