#!/usr/bin/env python3
"""One run of one cell with the program's own tracer on
(``repro_torch.obs``): the benchmark's run, with ``obs.enable()`` before the
cell's set-up and ``obs.clear()`` just before the window, and the readers
of the program's spans, device events and counters after it.

    python3 portbench/program_trace.py --workload serve-sessions \
        --seed 7 --seconds 48 --trace 0

``--trace 1`` also runs the profiler over the window, as the benchmark's
traced run does.  The last line of standard output is one JSON object:
``correct``, the cell's end-to-end metrics (measured with the program's
tracer on), ``setup_s``, each reader of ``READERS`` under ``metrics``
(None where it found nothing to read) and, in the serving cells, the
profiler-free ticks by kind under ``breakdown``.  Run from the root of a
checkout on a machine with the card.  Not part of a benchmark run.
"""
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

#: the readers of the program's records (``portbench/metrics/<name>.py``),
#: by the driver of the cell's traffic
READERS = {
    "serve": ("tick_gap_share", "tick_host_ms", "prefix_lanes_ms",
              "admit_prefill_ms", "decode_step_ms", "prefill_useful_share"),
    "replay": ("k3_chain_ns",),
}


def tick_breakdown(run) -> dict:
    """Means over the profiler-free ticks, by kind: the count, the host
    milliseconds of the step, the device milliseconds start to end, the
    gap before it, and each phase's device milliseconds (None where not
    measured)."""
    from bench import program
    out = {}
    for kind in ("admit", "decode"):
        ticks = [s for s, _ in program.serve_ticks(run) or ()
                 if s.attrs.get("kind") == kind]

        def mean(key):
            return program.mean([s.attrs[key] for s in ticks
                                 if s.attrs.get(key) is not None])
        phases = {}
        for s in ticks:
            for p, ms in s.attrs.get("phases", ()):
                if ms is not None:
                    phases.setdefault(p, []).append(ms)
        out[kind] = {"ticks": len(ticks),
                     "host_ms": program.mean([s.ms for s in ticks]),
                     "tick_ms": mean("tick_ms"), "gap_ms": mean("gap_ms"),
                     "phase_ms": {p: program.mean(v)
                                  for p, v in phases.items()}}
    return out


def run_cell(bench, name, seed, seconds, trace, device, *, config=None,
             traffic=None) -> dict:
    """``bench.main.execute``'s run of cell ``name`` with the program's
    tracer on from before the set-up -> the result dict."""
    import torch

    from bench import main, registry
    from bench.trace import Tracer
    from repro_torch import obs

    wl = registry.find(bench["workloads"], name, "workload")
    config = config or registry.config(bench, wl)
    traffic = traffic or registry.traffic(wl["traffic"])
    run = main.Run(workload=wl, config=config, traffic=traffic, seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   kind=main.device_kind(device))
    cell = registry.driver(traffic["drive"]).Cell(run)
    t0 = time.perf_counter()
    obs.enable()
    try:
        cell.setup()
        run.sync()
        setup_s = time.perf_counter() - t0
        obs.clear()
        with Tracer(trace, seconds, traffic.get("trace_last_seconds")) as tr:
            cell.window(tr)
            run.sync()
    finally:
        obs.disable()
    run.timeline = tr.timeline
    metrics = {m: registry.metric_reader(m)(run)
               for m in READERS[traffic["drive"]]}
    breakdown = (tick_breakdown(run) if traffic["drive"] == "serve"
                 else None)
    obs.clear()
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    return {"correct": all(c.ok for c in checks), "workload": name,
            "seed": seed, "trace": bool(trace), "setup_s": setup_s,
            "end_to_end": cell.end_to_end(), "metrics": metrics,
            "breakdown": breakdown,
            "checks": {c.name: c.value for c in checks},
            "device": run.kind}


def main_(argv) -> int:
    import torch

    from bench import main, registry
    args = main.parse(argv)
    bench = registry.benchmark()
    wl = registry.find(bench["workloads"], args.workload, "workload")
    device = main.look_for_card(wl.get("chips", 1))
    if device is None:
        return 2
    torch.cuda.set_device(device)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
