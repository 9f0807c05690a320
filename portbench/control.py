#!/usr/bin/env python3
"""The controls of the cells' checks: readings that a sound check must
call wrong.  Not part of a benchmark run.

    python3 portbench/control.py --workload serve-sessions \
        --seeds 11,12,13 --seconds 10

* Replay cells: the reference with its LRU guarantee broken (recency kept
  per batch, not per request: ``batch_clock``) in the program's place;
  prints the numbers the cell's check would compare (they must not be 0).
* Serving cells: a short window of the program, then on its checked sample
  the widest gap of the tokens an fp8 forward puts first (the precision
  below the bf16 the configuration serves in), beside the program's own.

One JSON line per seed on standard output.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def cache_control(run) -> dict:
    """The replay cell's numbers with the control in the program's
    place."""
    from bench.drive_replay import draw_traces
    from reference import kway as kref
    cfg, t, dev = run.config, run.traffic, run.device
    chunks = draw_traces(t, run.seed, dev)
    want = kref.empty(t["traces"], cfg["num_sets"], cfg["ways"], dev)
    wh, we = kref.replay(want, chunks)
    got = kref.empty(t["traces"], cfg["num_sets"], cfg["ways"], dev)
    gh, ge = kref.replay(got, chunks, batch_clock=True)
    return {"replays_wrong": int(((wh != gh) | (we != ge)).any(1).sum()),
            "state_words_wrong": sum(
                int((got.lanes(i)[f] != want.lanes(i)[f]).sum())
                for i in range(t["traces"])
                for f in ("keys", "vals", "meta_a"))}


def serve_control(run) -> dict:
    from bench import main, registry
    from bench.trace import Tracer
    cell = registry.driver("serve").Cell(run)
    cell.setup()
    with Tracer(False) as tr:
        cell.window(tr)
    cell.release()
    checks = {c.name: c.value for c in cell.check()}
    return {"program": checks, "served": len(cell.done),
            "control_logit_gap": cell.served_gap(fp8=True),
            "device": main.device_kind(run.device)}


def main_(argv) -> int:
    import argparse

    import torch
    from bench import main, registry
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.find(bench["workloads"], args.workload, "workload")
    device = main.look_for_card(wl.get("chips", 1))
    if device is None:
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        traffic = registry.traffic(wl["traffic"])
        run = main.Run(workload=wl, config=registry.config(bench, wl),
                       traffic=traffic, seed=seed, seconds=args.seconds,
                       trace=False, device=device,
                       kind=main.device_kind(device))
        out = (serve_control(run) if traffic["drive"] == "serve"
               else cache_control(run))
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
