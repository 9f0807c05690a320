"""Render the dry run's summary and roofline tables from
dryrun_results.json (counterpart of ``repro/roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report [dryrun_results.json]

The tables are the dry run's estimate for an H100 mesh, not a
measurement.
"""
from __future__ import annotations

import json
import sys

from repro_torch.roofline import analysis as roof


def _fmt_bytes(b):
    return f"{b/2**30:.2f}"


def render(results: dict) -> str:
    out = []
    out.append("### Dry-run summary\n")
    ok = [r for r in results.values() if r.get("status") == "ok"]
    sk = [r for r in results.values() if r.get("status") == "skipped"]
    fl = [r for r in results.values() if r.get("status") == "fail"]
    out.append(f"compiled cells: {len(ok)}   documented skips: {len(sk)}   "
               f"failures: {len(fl)}\n")
    out.append("| arch | shape | mesh | chips | args GiB/dev | temp GiB/dev | compile s |")
    out.append("|---|---|---|---:|---:|---:|---:|")
    for key in sorted(results):
        r = results[key]
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | "
                       f"skip: {r['reason'][:40]}… |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | "
                       f"FAIL {r.get('error','')[:40]} |")
            continue
        m = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
            f"| {_fmt_bytes(m['argument_bytes'])} "
            f"| {_fmt_bytes(m['temp_bytes'])} | {r.get('compile_s','')} |"
        )

    out.append(f"\n### Roofline (single-pod 16x16, 256 GPUs; H100: "
               f"{roof.PEAK_FLOPS / 1e12:g} TFLOP/s bf16, "
               f"{roof.HBM_BW / 1e12:g} TB/s HBM, "
               f"{roof.LINK_BW / 1e9:g} GB/s link)\n")
    out.append("| arch | shape | t_compute s | t_memory s | t_collective s "
               "| bottleneck | MODEL_FLOPS | useful ratio | roofline frac |")
    out.append("|---|---|---:|---:|---:|---|---:|---:|---:|")
    for key in sorted(results):
        r = results[key]
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rf['t_compute']:.4f} | {rf['t_memory']:.4f} "
            f"| {rf['t_collective']:.4f} | {rf['bottleneck']} "
            f"| {rf['model_flops']:.3g} | {rf['useful_flops_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.3f} |"
        )
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main()
