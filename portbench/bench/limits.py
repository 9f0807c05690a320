"""The limits that decide ``correct``: ``portbench/limits/<workload>.json``
maps each number a cell compares to its limit (how each was set is in
PERF.md).  A number is held to ``value <= limit``."""
from __future__ import annotations

import dataclasses

from bench import registry


@dataclasses.dataclass
class Check:
    """One number the run compares, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def limits_of(workload: str) -> dict:
    return registry.load_json(registry.ROOT / "limits" / f"{workload}.json")


def checks(workload: str, values: dict) -> list:
    """``values`` {name: number} -> [Check], each against the cell's
    limit."""
    lim = limits_of(workload)
    missing = set(values) ^ set(lim)
    if missing:
        raise KeyError(f"limits of {workload!r} and its numbers differ: "
                       f"{sorted(missing)}")
    return [Check(k, v, lim[k]) for k, v in values.items()]
