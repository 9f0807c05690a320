"""CLI: reproduce a paper figure on the port, emit its artifact, gate
against a baseline.

    PYTHONPATH=src python -m repro_torch.eval --fig hit_ratio --quick
    PYTHONPATH=src python -m repro_torch.eval --fig hit_ratio --quick \
        --baseline benchmarks/baselines/quick.json        # exit 2 on breach
    PYTHONPATH=src python -m repro_torch.eval --fig robustness --quick \
        --device cpu                                      # off the card

A baseline written by the reference (``repro.eval``) is joined through
``artifacts.port_id``.  Exit codes: 0 ok, 1 usage/figure error, 2 baseline
tolerance breach.  Without ``--device`` the figures run on the card.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.eval import artifacts
from repro_torch.eval.figures import FIGURES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="Paper-figure sweep harness of the PyTorch/CUDA port.")
    ap.add_argument("--fig", required=True,
                    choices=sorted(FIGURES) + ["all"],
                    help="figure family to reproduce")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized grid: fewer requests and a single seed")
    ap.add_argument("--out", default=None,
                    help="artifact path (default BENCH_<figure>.json)")
    ap.add_argument("--baseline", default=None,
                    help="compare against this artifact; non-zero exit on "
                         "tolerance breach")
    ap.add_argument("--tol", type=float, default=artifacts.DEFAULT_TOL,
                    help="default |delta| tolerance for comparable records "
                         f"(default {artifacts.DEFAULT_TOL})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the figures run (default: the card)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    names = sorted(FIGURES) if args.fig == "all" else [args.fig]
    if args.fig == "all" and args.out:
        ap.error("--out is per-figure; drop it with --fig all")
    if args.fig == "all" and args.baseline:
        ap.error("--baseline is per-figure; pick one --fig")

    rc = 0
    for name in names:
        fn, figure = FIGURES[name]
        progress = None if args.quiet else (
            lambda msg, _n=name: print(f"  [{_n}] {msg}", flush=True))
        t0 = time.time()
        if not args.quiet:
            print(f"== {figure} ({'quick' if args.quick else 'full'}, "
                  f"{args.device}) ==", flush=True)
        spec, records, skipped = fn(quick=args.quick, progress=progress,
                                    device=args.device)
        art = artifacts.make_artifact(figure, spec, records, skipped,
                                      device=args.device)
        out = args.out or f"BENCH_{figure}.json"
        artifacts.write_artifact(out, art)
        if not args.quiet:
            for s in skipped:
                print(f"  skipped: {s}")
            print(f"  {len(records)} records -> {out} "
                  f"({time.time() - t0:.1f}s)", flush=True)

        if args.baseline:
            base = artifacts.load_artifact(args.baseline)
            breaches = artifacts.compare_to_baseline(art, base, tol=args.tol)
            if breaches:
                print(f"BASELINE BREACH vs {args.baseline}:",
                      file=sys.stderr)
                for b in breaches:
                    print(f"  {b}", file=sys.stderr)
                rc = 2
            elif not args.quiet:
                n_cmp = sum(1 for r in base["records"]
                            if r.get("comparable", False))
                print(f"  baseline ok: {n_cmp} comparable records within "
                      f"tolerance of {args.baseline}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
