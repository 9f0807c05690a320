"""One run of one cell: look for the card, set up, measure the window,
check the outputs against the plain reference, print the result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The last line of standard output is the result's JSON; everything else
goes to standard error, whose last lines are each compared number beside
its limit.  Exit codes: 0 a result (correct or not), 2 no card (or too
few), 3 a forbidden module was loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import torch

from bench import registry
from bench.trace import Tracer

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a driver and the metric readers see of one run."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    kind: str
    records: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    timeline: object = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among ``names`` (the loaded modules'
    names by default), compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def look_for_card(chips: int):
    """The card the cell runs on, or None (with the reason on stderr)."""
    if not torch.cuda.is_available():
        say("no CUDA device is available: the benchmark runs on the card")
        return None
    if torch.cuda.device_count() < chips:
        say(f"the cell needs {chips} cards; {torch.cuda.device_count()} "
            f"are available")
        return None
    return torch.device("cuda", 0)


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, setup_clock, *, config=None,
            traffic=None) -> tuple:
    """Run cell ``name`` on ``device``.  ``setup_clock()`` gives the seconds
    since the process started.  ``config`` / ``traffic`` replace the files
    the entries name (the tests' small sizes).
    -> (result dict, checks, setup seconds)."""
    wl = registry.find(bench["workloads"], name, "workload")
    config = config or registry.config(bench, wl)
    traffic = traffic or registry.traffic(wl["traffic"])
    run = Run(workload=wl, config=config, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, device=device,
              kind=device_kind(device))
    cell = registry.driver(traffic["drive"]).Cell(run)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell.setup()
    run.sync()
    setup_s = setup_clock()
    with Tracer(trace, seconds, traffic.get("trace_last_seconds")) as tr:
        cell.window(tr)
        run.sync()
    run.timeline = tr.timeline
    if tr.start_at is not None:
        run.records["trace_start_s"] = tr.start_s
    if tr.read_s is not None:
        say(f"trace stop_s {tr.read_s[0]!r} reduce_s {tr.read_s[1]!r} "
            f"device_ops {len(tr.timeline.names) if tr.timeline else 0}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    refuse_forbidden("the window")
    t_check = time.perf_counter()
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    say(f"window_s {run.window_s!r} check_s "
        f"{time.perf_counter() - t_check!r}")

    metrics = {}
    if trace:
        for m in registry.metrics_of(bench, "per_layer", name):
            v = registry.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(cell.end_to_end(), setup_s=setup_s)
        for m in registry.metrics_of(bench, "end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.kind, "count": wl.get("chips", 1),
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if trace and run.timeline is not None:
        tl = run.timeline
        dev.update(busy_s=tl.busy_s, window_s=tl.window_s)
        result["breakdown"] = {"device_ops": tl.top_ops(),
                               "idle_gaps": tl.top_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    # the check and the metric readers run after the window: whatever they
    # load is in this process too when the result is printed
    refuse_forbidden("the check and the metric readers")
    return result, checks, setup_s


class ForbiddenModule(RuntimeError):
    pass


def refuse_forbidden(after: str) -> None:
    """Raise ForbiddenModule if a FORBIDDEN module is loaded by now."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModule(f"{', '.join(bad)} (loaded by the end of "
                              f"{after})")


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, setup_clock) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    wl = registry.find(bench["workloads"], args.workload, "workload")
    device = look_for_card(wl.get("chips", 1))
    if device is None:
        return 2
    torch.cuda.set_device(device)
    try:
        result, checks, setup_s = execute(
            bench, args.workload, args.seed, args.seconds, bool(args.trace),
            device, setup_clock)
    except ForbiddenModule as e:
        say(f"forbidden modules loaded: {e}")
        return 3
    say(f"setup_s {setup_s!r}")
    for c in checks:
        say(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
