"""The port's dry run (``repro_torch.launch.dryrun``) on fake meshes in
this one process: train, prefill and decode cells of a dense, a MoE and
an encoder-decoder config (widened so that some leaves are sharded) on
2x2 and 2x2x2 meshes; the record's schema is the reference's, and the
per-device argument bytes are the local shards' bytes counted here from
the placements.  A train cell with remat against the same cell without:
a lower live peak, more FLOPs by at most one forward.  ``main``'s resume, documented skips and exit code on a
stubbed ``run_cell``."""
import dataclasses
import json
import math

import pytest
from torch.distributed.tensor import Shard

from repro.roofline import analysis as ref_roof
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw

ARCHS = ("deepseek-7b", "mixtral-8x22b", "seamless-m4t-large-v2")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: batches the data axes divide (2 or 4); 12 is no multiple of 8, so the
#: train cell runs one microbatch
SHAPES = (configs.ShapeConfig("train_s", 32, 12, "train"),
          configs.ShapeConfig("prefill_s", 32, 4, "prefill"),
          configs.ShapeConfig("decode_s", 32, 4, "decode"))
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
              "generated_code_bytes"}


def widened(arch):
    """The smoke config widened so that stacked leaves of the embedding
    and the MLP pass the 1 Mi-element sharding threshold."""
    return dataclasses.replace(configs.get(arch).smoke, d_model=512,
                               d_ff=2048, vocab_size=4096)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh(request):
    import torch.distributed as dist

    shape, names = MESHES[request.param]
    mesh_lib.start_fake_group(math.prod(shape))
    yield mesh_lib.make_mesh(shape, names, "cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _local(shape, placements, mesh) -> int:
    n = math.prod(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n //= mesh.size(m)
    return n


def expected_argument_bytes(cfg, shape, mesh) -> int:
    """The local shards' bytes of the cell's arguments, from the
    placements alone."""
    model = configs.param_specs(cfg)
    pl = shd.param_shardings(cfg, model, mesh)
    total = 0
    for n, p in model.named_parameters():
        total += _local(p.shape, pl[n], mesh) * p.element_size()
    if shape.kind == "train":
        st = adamw.state_shardings(pl, mesh, model)
        for n, p in model.named_parameters():
            total += 3 * 4 * _local(p.shape, st["master"][n], mesh)
        total += 4                                     # the int32 step
    isp = configs.input_specs(cfg, shape)
    for k, v in shd.input_shardings(cfg, shape, isp, mesh).items():
        total += _local(isp[k].shape, v, mesh) * isp[k].element_size()
    if shape.kind == "decode":
        csp = configs.cache_specs(cfg, shape)
        for k, v in shd.cache_shardings(cfg, shape, csp, mesh).items():
            total += _local(csp[k].shape, v, mesh) * csp[k].element_size()
    return total


def _ref_roofline_keys() -> set:
    cell = ref_roof.CellRoofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0,
                                 0.0)
    return set(cell.to_json())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_record(mesh, arch, shape):
    cfg = widened(arch)
    pl = shd.param_shardings(cfg, configs.param_specs(cfg), mesh)
    assert any(any(isinstance(p, Shard) for p in v) for v in pl.values())
    rec = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg)
    assert {"arch", "shape", "mesh", "chips", "memory", "compile_s",
            "roofline", "total_s"} <= set(rec)
    assert rec["mesh"] == "x".join(map(str, mesh.shape))
    assert rec["chips"] == mesh.size() and rec["mesh_device"] == "cpu"
    assert set(rec["memory"]) == REF_MEMORY
    assert rec["memory"]["argument_bytes"] == expected_argument_bytes(
        cfg, shape, mesh)
    assert rec["memory"]["temp_bytes"] > 0
    r = rec["roofline"]
    assert set(r) == _ref_roofline_keys()
    assert r["hlo_flops"] == rec["counted"]["flops"] * mesh.size()
    assert r["coll_bytes"] == sum(r["coll_breakdown"].values())
    assert r["coll_bytes"] > 0                   # the model axis gathers
    assert set(r["coll_breakdown"]) <= {"all-reduce", "all-gather",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"}
    assert r["hlo_flops"] > 0 and r["model_flops"] > 0
    json.dumps(rec)


#: a train cell whose activations outweigh the rest of its peak (at seq 32
#: the peak is the logits' and the optimizer's), and its forward alone
REMAT_TRAIN = configs.ShapeConfig("train_r", 128, 12, "train")
REMAT_PREFILL = configs.ShapeConfig("prefill_r", 128, 12, "prefill")


@pytest.mark.parametrize("mesh", ["2x2"], indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_remat(mesh, arch, monkeypatch):
    """A train cell runs the remat step: a lower live peak than the same
    step with ``remat=False``, and more FLOPs, by the recomputed forward
    (its batched products) and by no more than one forward (the prefill
    cell of the same tokens).  Prefill and decode cells build no graph and
    never enter the checkpoint, so their records are as before."""
    cfg = widened(arch)
    on = dryrun.run_cell(arch, REMAT_TRAIN, mesh=mesh, cfg=cfg)
    off = dryrun.run_cell(arch, REMAT_TRAIN, mesh=mesh, cfg=cfg, remat=False)
    assert (on["remat"], off["remat"]) == (True, False)
    assert on["memory"]["temp_bytes"] < off["memory"]["temp_bytes"]
    assert on["memory"]["argument_bytes"] == off["memory"]["argument_bytes"]

    def no_checkpoint(*a, **kw):
        raise AssertionError("a step without grad entered the checkpoint")

    monkeypatch.setattr(dryrun.lm, "checkpoint", no_checkpoint)
    fwd = dryrun.run_cell(arch, REMAT_PREFILL, mesh=mesh, cfg=cfg)
    extra = on["counted"]["flops"] - off["counted"]["flops"]
    assert 0 < extra <= fwd["counted"]["flops"]
    assert on["counted"]["bytes"] > off["counted"]["bytes"]
    dec = dryrun.run_cell(arch, SHAPES[2], mesh=mesh, cfg=cfg)
    assert "remat" not in fwd and "remat" not in dec


@pytest.mark.parametrize("mesh", ["2x2"], indirect=True)
def test_run_cell_lists_peak_storages(mesh):
    """``trace_bytes`` lists the storages alive at the peak, largest
    first, each with its op and the port's line; the counts are the same
    as without it.  A long prefill's peak is its attention scores."""
    cfg = widened("deepseek-7b")
    shape = configs.ShapeConfig("prefill_q", 6144, 4, "prefill")
    score = 2 * cfg.num_heads * 2048 * 6144 * 4        # rows x heads x qc x S
    rec = dryrun.run_cell("deepseek-7b", shape, mesh=mesh, cfg=cfg,
                          roofline=False, trace_bytes=score)
    plain = dryrun.run_cell("deepseek-7b", shape, mesh=mesh, cfg=cfg,
                            roofline=False)
    assert rec["memory"] == plain["memory"]
    listed = rec["counted"]["peak_storages"]
    assert listed and all(n >= score for n, _, _ in listed)
    assert [n for n, _, _ in listed] == sorted(
        (n for n, _, _ in listed), reverse=True)
    assert all(where.startswith("repro_torch/models/layers.py:")
               for _, _, where in listed)
    assert sum(n for n, _, _ in listed) <= rec["counted"]["peak_new_bytes"]


def test_main_resumes_skips_and_fails(tmp_path, monkeypatch):
    """``main`` writes the documented long_500k skips, records a failing
    cell and exits 1; rerun, it resumes: only the failed cell runs again,
    and with it passing the exit code is 0."""
    out = str(tmp_path / "dr.json")
    calls = []
    fail = {"on": True}

    def fake_run_cell(arch_id, shape, *, multi_pod, roofline, device_type):
        calls.append((arch_id, shape.name, multi_pod))
        if fail["on"] and shape.name == "decode_32k":
            raise RuntimeError("no sharding strategy for aten.foo")
        return {"arch": arch_id, "shape": shape.name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "chips": 512 if multi_pod else 256,
                "memory": {k: 0 for k in REF_MEMORY}, "compile_s": 0.0}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    rc = dryrun.main(["--arch", "deepseek-7b", "--out", out])
    res = json.load(open(out))
    assert rc == 1
    assert res["deepseek-7b|long_500k|single"]["status"] == "skipped"
    assert res["deepseek-7b|long_500k|multi"]["reason"] == dryrun.LONG_SKIP
    assert res["deepseek-7b|decode_32k|single"]["status"] == "fail"
    assert "aten.foo" in res["deepseek-7b|decode_32k|multi"]["error"]
    assert res["deepseek-7b|train_4k|single"]["status"] == "ok"
    assert len(calls) == 6                       # 3 shapes x 2 meshes
    calls.clear()
    fail["on"] = False
    assert dryrun.main(["--arch", "deepseek-7b", "--out", out]) == 0
    assert sorted(calls) == [("deepseek-7b", "decode_32k", False),
                             ("deepseek-7b", "decode_32k", True)]
    res = json.load(open(out))
    assert all(r["status"] in ("ok", "skipped") for r in res.values())
    from repro_torch.roofline.report import render
    assert "documented skips: 2" in render(res)
