"""The reference's dry run (``repro.launch.dryrun``) on a mesh of ``Auto``
axes, cell by cell, with the partition of its attention scores read from
the compiled HLO.

``repro.launch.mesh.make_production_mesh`` calls ``jax.make_mesh``, which
on jax 0.9 makes ``Explicit`` axes; the reference's own
``with_sharding_constraint`` (``repro/models/lm.py``) refuses those, so
its ``run_cell`` fails as shipped.  This helper builds the same meshes
with ``AxisType.Auto`` axes and compiles each cell's production artifact
(``lower_cell(cfg, shape, mesh, unroll=<decode>)``, as ``run_cell`` does
for its memory record).  Nothing of the reference is edited.

Per cell it records the reference's ``memory`` fields and ``scores``: the
largest float32 rank-5 shapes of the compiled module whose last
dimension is the key length (``[B, KVH, G, S_q, T]`` per device), which
say whether the partitioner split the heads.

Usage:
    PYTHONPATH=src python tests/ref_dryrun_auto.py [--arch A] [--shape S]
        [--skip-multi-pod] [--out ref_dryrun_results.json]
    PYTHONPATH=src python tests/ref_dryrun_auto.py --out R.json --table \
        dryrun_results.json        # the port's temp beside the reference's
    PYTHONPATH=src python tests/ref_dryrun_auto.py --cells '[{"arch": ...,
        "shape": [name, seq, batch, kind], "mesh": [2, 2], "smoke": true,
        "overrides": {"d_model": 512}}, ...]'   # records, JSON on stdout

Results accumulate in the ``--out`` file (resumable); a cell that fails
is recorded with its error.  Run it on the CPU: ``JAX_PLATFORMS=cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.launch.dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models.layers import ATTN_Q_CHUNK  # noqa: E402

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
PRODUCTION = {False: (16, 16), True: (2, 16, 16)}
MEMORY = ("argument_bytes", "temp_bytes", "output_bytes")
_F32 = re.compile(r"f32\[(\d+),(\d+),(\d+),(\d+),(\d+)\]")


def auto_mesh(shape):
    """A mesh of ``shape`` over the first devices, every axis ``Auto``."""
    n = math.prod(shape)
    return jax.make_mesh(tuple(shape), AXES[len(shape)],
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def score_shapes(hlo: str, cfg, shape: ShapeConfig, top: int = 3) -> list:
    """The largest float32 [B, KVH, G, S_q, T] shapes of ``hlo`` whose T
    is the cell's key length (decode: S_q = 1; an encoder-decoder's
    sequence is half tokens, half frames)."""
    t = shape.seq_len
    if cfg.enc_layers > 0 and shape.kind != "decode":
        t //= 2
    seen = set()
    for m in _F32.finditer(hlo):
        dims = tuple(int(d) for d in m.groups())
        if dims[4] != t:
            continue
        if shape.kind == "decode" and dims[3] != 1:
            continue
        if shape.kind != "decode" and dims[3] not in (t, ATTN_Q_CHUNK):
            continue
        seen.add(dims)
    return [list(d) for d in sorted(seen, key=math.prod, reverse=True)[:top]]


def ref_cell(cfg, shape: ShapeConfig, mesh_shape) -> dict:
    """Compile one cell's production artifact on an ``Auto`` mesh ->
    {"memory": the reference's fields, "scores": ..., "compile_s"}."""
    t0 = time.time()
    mesh = auto_mesh(mesh_shape)
    compiled = ref_dryrun.lower_cell(
        cfg, shape, mesh, unroll=shape.kind == "decode").compile()
    mem = compiled.memory_analysis()
    return {
        "mesh": "x".join(map(str, mesh_shape)),
        "memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "generated_code_bytes": mem.generated_code_size_in_bytes,
        },
        "scores": score_shapes(compiled.as_text(), cfg, shape),
        "compile_s": round(time.time() - t0, 1),
    }


def _one(spec: dict) -> dict:
    cfg = dataclasses.replace(configs.get(spec["arch"]).config
                              if not spec.get("smoke")
                              else configs.get(spec["arch"]).smoke,
                              **spec.get("overrides", {}))
    return ref_cell(cfg, ShapeConfig(*spec["shape"]), spec["mesh"])


def table(ref_path: str, port_paths) -> str:
    """Markdown: per cell, temp GiB a device of the port and the reference
    and their ratio on 16x16 and 2x16x16, and the port's whole peak
    (arguments + temp + outputs) on 16x16."""
    with open(ref_path) as f:
        ref = json.load(f)
    port = {}
    for path in port_paths:
        with open(path) as f:
            port.update({k: v for k, v in json.load(f).items()
                         if v.get("status") == "ok"})
    rows = ["| arch | shape | temp 16x16: port / ref (ratio) | temp "
            "2x16x16: port / ref (ratio) | port peak 16x16 |",
            "|---|---|---|---|---:|"]
    gib = 2 ** 30
    for arch_id in configs.ARCH_IDS:
        for shape in configs.get(arch_id).shapes():
            cols = []
            for mesh in ("single", "multi"):
                key = f"{arch_id}|{shape.name}|{mesh}"
                p, r = port.get(key), ref.get(key)
                if not (p and r and r.get("status") == "ok"):
                    cols.append("not run")
                    continue
                pt, rt = (p["memory"]["temp_bytes"],
                          r["memory"]["temp_bytes"])
                same = (p["memory"]["argument_bytes"]
                        == r["memory"]["argument_bytes"])
                cols.append(f"{pt / gib:.2f} / {rt / gib:.2f} "
                            f"({pt / rt:.2f}x)"
                            + ("" if same else ", arguments differ"))
            p = port.get(f"{arch_id}|{shape.name}|single")
            peak = ("not run" if p is None else
                    f"{sum(p['memory'][k] for k in MEMORY) / gib:.2f}")
            rows.append(f"| {arch_id} | {shape.name} | {cols[0]} | "
                        f"{cols[1]} | {peak} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=None,
                    help="a JSON list of cells; prints their records")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--skip-multi-pod", action="store_true")
    ap.add_argument("--out", default="ref_dryrun_results.json")
    ap.add_argument("--table", nargs="+", default=None, metavar="PORT_JSON",
                    help="print the port's temp (its dry run's results "
                         "files) beside the --out file's, as markdown")
    args = ap.parse_args(argv)
    if args.cells is not None:
        print(json.dumps([_one(c) for c in json.loads(args.cells)]))
        return 0
    if args.table is not None:
        print(table(args.out, args.table))
        return 0

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    fails = 0
    for arch_id in configs.ARCH_IDS:
        spec = configs.get(arch_id)
        if args.arch and arch_id != args.arch:
            continue
        for shape in spec.shapes():
            if args.shape and shape.name != args.shape:
                continue
            for name, mp in [("single", False)] + (
                    [] if args.skip_multi_pod else [("multi", True)]):
                key = f"{arch_id}|{shape.name}|{name}"
                if results.get(key, {}).get("status") == "ok":
                    continue
                print(f"=== {key} ===", flush=True)
                try:
                    rec = ref_cell(spec.config, shape, PRODUCTION[mp])
                    rec.update(arch=arch_id, shape=shape.name, status="ok")
                    print(f"    ok in {rec['compile_s']}s temp="
                          f"{rec['memory']['temp_bytes'] / 2**30:.2f}GiB "
                          f"scores={rec['scores'][:1]}", flush=True)
                except Exception as e:  # noqa: BLE001 — record, continue
                    fails += 1
                    rec = {"arch": arch_id, "shape": shape.name,
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"[:2000]}
                    traceback.print_exc()
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
