"""Multi-pod dry run: every (arch x shape x mesh) cell's step on DTensors
under ``FakeTensorMode``, with no device memory and no hardware.

Counterpart of ``repro/launch/dryrun.py``.  For each cell it shows,
without hardware:
  * the sharding rules are coherent: the step runs on the 16x16
    single-pod mesh AND the 2x16x16 multi-pod mesh (a fake process group
    of 256 or 512 ranks in this one process, ``launch/mesh.py``);
  * it fits: per-device argument, temporary and output bytes of the full
    step (a train step rematerialises every block, as the reference's
    scanned + remat step does: ``lm.forward``);
  * the roofline terms (``roofline/analysis.py``), counted on one rank's
    local ops by ``StepCounter``.

The reference lowers each step with XLA: its production artifact scans
the layers, and since ``cost_analysis`` counts a scan body once it
extrapolates its costs from 1- and 2-period unrolled lowerings.  Eager
torch runs every layer op by op, so the port counts the full depth
directly and needs no extrapolation.  The step is the port's own:
``train.step.make_train_step`` (loss, autograd gradients through the
remat forward, ``adamw.update``
with the ZeRO placements of ``adamw.state_shardings``; 8 microbatches
when the batch divides, as the reference's production artifact),
``lm.forward`` (prefill) and ``lm.decode_step`` (decode), all inside
``implicit_replication()`` (a plain tensor such as a rope table or a
mask meets a DTensor as a replicated one).

Memory per device, the reference's ``memory`` fields: ``argument_bytes``
the local shards of the parameters, optimizer state, inputs and cache
that the step reads (XLA's compile drops an argument its computation
never reads, as mamba2's ``ln2``: its blocks have no MLP);
``output_bytes`` what the step returns in storage of its own;
``temp_bytes`` the most bytes alive at once that the step created, less
the outputs.  A train step's FLOPs and bytes include the backward's
recomputed forward, as the reference's ``cost_analysis`` of its remat
lowering does.  ``compile_s`` is the seconds of the fake run.

The fake mesh is ``"cpu"``-typed unless ``--mesh-device cuda``: the dry
run touches no device either way, but DTensor lowers an all-to-all on a
``"cpu"`` mesh into an all-gather and a chunk, so the collective
breakdown depends on the type, which each record names (``mesh_device``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --skip-multi-pod [--layers 2]
Results accumulate in dryrun_results.json (resumable; --force recomputes);
exit code 1 when any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roof
from repro_torch.train.step import TrainConfig, make_train_step

RESULTS_PATH = "dryrun_results.json"
LONG_SKIP = ("pure full-attention arch; long_500k requires sub-quadratic "
             "attention (DESIGN.md §4)")


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def microbatches_for(shape: ShapeConfig) -> int:
    return 8 if shape.global_batch % 8 == 0 else 1


def build_train_fn(cfg: ModelConfig, microbatches: int = 1,
                   remat: bool = True):
    """(model, opt_state, batch) -> (model, opt_state, metrics): the
    trainer's step (in place), gradients accumulated over
    ``microbatches``; ``remat=False`` keeps every block's activations."""
    return make_train_step(cfg, TrainConfig(microbatches=microbatches,
                                            remat=remat))


def build_prefill_fn(cfg: ModelConfig):
    def step(model, batch):
        return lm.forward(cfg, model, batch["tokens"],
                          prefix_embeds=batch.get("prefix_embeds"),
                          enc_embeds=batch.get("enc_embeds"))

    return step


def build_decode_fn(cfg: ModelConfig):
    def step(model, cache, batch):
        return lm.decode_step(cfg, model, batch["token"], batch["pos"],
                              cache)

    return step


# ---------------------------------------------------------------------------
# one cell on one mesh
# ---------------------------------------------------------------------------

def place_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, device,
               batch: dict | None = None, model=None,
               microbatches: int | None = None, remat: bool = True):
    """The cell's step and its arguments as DTensors on ``mesh``:
    -> (fn, args, argument tensors).  Under ``FakeTensorMode`` nothing is
    allocated.  ``batch`` / ``model`` (full tensors) replace the empty
    specs for a real run; ``microbatches`` None: ``microbatches_for``;
    ``remat`` (train only) False: the step without rematerialisation."""
    if model is None:
        model = configs.param_specs(cfg, device=device)
    pl = shd.param_shardings(cfg, model, mesh)
    shd.distribute_model(model, mesh, pl)
    ispecs = batch if batch is not None else configs.input_specs(
        cfg, shape, device=device)
    inputs = shd.distribute_tree(
        ispecs, mesh, shd.input_shardings(cfg, shape, ispecs, mesh))
    tensors = list(model.parameters()) + list(inputs.values())
    if shape.kind == "train":
        opt = adamw.init(model, adamw.state_shardings(pl, mesh, model))
        tensors += [t for k in ("master", "m", "v")
                    for t in opt[k].values()] + [opt["step"]]
        fn = build_train_fn(cfg, microbatches or microbatches_for(shape),
                            remat)
        return fn, (model, opt, inputs), tensors
    if shape.kind == "prefill":
        return build_prefill_fn(cfg), (model, inputs), tensors
    cspecs = configs.cache_specs(cfg, shape, device=device)
    cache = shd.distribute_tree(
        cspecs, mesh, shd.cache_shardings(cfg, shape, cspecs, mesh))
    tensors += list(cache.values())
    return build_decode_fn(cfg), (model, cache, inputs), tensors


def _storages(tensors) -> set:
    from torch.distributed.tensor import DTensor

    return {id((t.to_local() if isinstance(t, DTensor) else t)
               .untyped_storage()) for t in tensors}


def count_step(fn, args, tensors, trace_bytes: int | None = None):
    """Run ``fn(*args)`` once under ``StepCounter`` (inside
    ``implicit_replication``) -> (output, counter, memory dict);
    ``trace_bytes``: list the storages of that size alive at the peak."""
    counter = roof.StepCounter(trace_bytes)
    counter.known(tensors)
    with implicit_replication(), counter:
        out = fn(*args)
    known = _storages(tensors)
    outs = [t for t in torch.utils._pytree.tree_flatten(out)[0]
            if isinstance(t, torch.Tensor)]
    seen, out_bytes = set(), 0
    for t in outs:
        key = next(iter(_storages([t])))
        if key not in known and key not in seen:
            seen.add(key)
            out_bytes += shd.local_bytes(t)
    memory = {
        "argument_bytes": sum(shd.local_bytes(t) for t in tensors
                              if _storages([t]) <= counter.read),
        "output_bytes": out_bytes,
        "temp_bytes": max(counter.peak_new - out_bytes, 0),
        "generated_code_bytes": 0,
    }
    return out, counter, memory


def run_cell(arch_id: str, shape: ShapeConfig, *, multi_pod: bool = False,
             roofline: bool = True, mesh=None, cfg: ModelConfig = None,
             device_type: str = "cpu", microbatches: int | None = None,
             remat: bool = True, trace_bytes: int | None = None) -> dict:
    """Run one cell's step under ``FakeTensorMode``; return the record for
    dryrun_results.json.  ``mesh`` None: the production mesh (fake group
    of its size, ``device_type``); ``cfg`` None: the arch's config;
    ``microbatches`` None: ``microbatches_for(shape)``; ``remat`` False:
    a train step that keeps every activation (the record says which);
    ``trace_bytes``: the record's ``counted.peak_storages`` lists the
    storages of at least that size alive at the peak, with the op and
    the port's line that made each."""
    cfg = cfg if cfg is not None else configs.get(arch_id).config
    if mesh is None:
        mesh_lib.start_fake_group(512 if multi_pod else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type=device_type)
    chips = mesh.size()
    rec = {"arch": arch_id, "shape": shape.name,
           "mesh": "x".join(str(s) for s in mesh.shape), "chips": chips,
           "mesh_device": mesh.device_type}
    if shape.kind == "train":
        rec["remat"] = remat
    t0 = time.time()
    with FakeTensorMode():
        fn, args, tensors = place_cell(cfg, shape, mesh, mesh.device_type,
                                       microbatches=microbatches,
                                       remat=remat)
        _, counter, rec["memory"] = count_step(fn, args, tensors,
                                               trace_bytes)
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["counted"] = counter.to_json()
    if not roofline:
        return rec
    coll = counter.collectives
    cell = roof.CellRoofline(
        arch=arch_id, shape=shape.name, mesh=rec["mesh"], chips=chips,
        hlo_flops=float(counter.flops) * chips,
        hlo_bytes=float(counter.bytes) * chips,
        coll_bytes=float(sum(coll.values())) * chips,
        coll_breakdown={k: v * chips for k, v in coll.items()},
        model_flops=roof.model_flops(cfg, shape),
        per_device_peak_memory=sum(
            rec["memory"][k] for k in ("argument_bytes", "temp_bytes",
                                       "output_bytes")),
    )
    rec["roofline"] = cell.to_json()
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` with ``layers`` decoder layers (and as many encoder layers
    where it has an encoder)."""
    return dataclasses.replace(cfg, num_layers=layers,
                               enc_layers=layers if cfg.enc_layers else 0)


def all_cells():
    for arch_id in configs.ARCH_IDS:
        spec = configs.get(arch_id)
        for shape in spec.shapes():
            yield arch_id, shape
        for shape in spec.skipped_shapes():
            yield arch_id, shape  # recorded as documented skips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--skip-multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--mesh-device", default="cpu", choices=["cpu", "cuda"],
                    help="device type of the fake mesh (nothing runs on "
                         "it either way)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every cell's depth to this many layers "
                         "(decoder and encoder; widths as published)")
    ap.add_argument("--peak-storages", type=float, default=None,
                    metavar="MIB", help="list the storages of at least "
                    "this many MiB alive at each cell's peak")
    args = ap.parse_args(argv)

    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    def save():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    for arch_id, shape in all_cells():
        if args.arch and arch_id != args.arch:
            continue
        if args.shape and shape.name != args.shape:
            continue
        spec = configs.get(arch_id)
        skipped = shape.name == "long_500k" and not spec.supports_long_context

        meshes = [("single", False)] + ([] if args.skip_multi_pod
                                        else [("multi", True)])
        for mesh_name, mp in meshes:
            key = f"{arch_id}|{shape.name}|{mesh_name}"
            if key in results and results[key].get("status") in ("ok",
                                                                  "skipped"):
                continue
            if skipped:
                results[key] = {"arch": arch_id, "shape": shape.name,
                                "mesh": mesh_name, "status": "skipped",
                                "reason": LONG_SKIP}
                save()
                continue
            print(f"=== {key} ===", flush=True)
            try:
                kw = {}
                if args.peak_storages is not None:
                    kw["trace_bytes"] = int(args.peak_storages * 2**20)
                if args.layers is not None:
                    kw["cfg"] = cut_depth(spec.config, args.layers)
                rec = run_cell(arch_id, shape, multi_pod=mp,
                               roofline=(mesh_name == "single"),
                               device_type=args.mesh_device, **kw)
                if args.layers is not None:
                    rec["layers"] = args.layers
                rec["status"] = "ok"
                results[key] = rec
                extra = ""
                if "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_fraction']:.3f}")
                gib = sum(rec["memory"][k] for k in (
                    "argument_bytes", "temp_bytes", "output_bytes")) / 2**30
                print(f"    ok in {rec.get('total_s', rec['compile_s'])}s"
                      f" mem/dev={gib:.2f}GiB" + extra, flush=True)
                listed = rec.get("counted", {}).get("peak_storages", [])
                for n, op, where in listed[:8]:
                    print(f"      at the peak: {n / 2**30:.3f} GiB {op} "
                          f"({where})", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                results[key] = {"arch": arch_id, "shape": shape.name,
                                "mesh": mesh_name, "status": "fail",
                                "error": f"{type(e).__name__}: {e}"}
                print("    FAIL:", type(e).__name__, str(e)[:500], flush=True)
                traceback.print_exc()
            save()

    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    sk = sum(1 for r in results.values() if r.get("status") == "skipped")
    fl = sum(1 for r in results.values() if r.get("status") == "fail")
    print(f"\nDONE ok={ok} skipped={sk} fail={fl}")
    return 0 if fl == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
