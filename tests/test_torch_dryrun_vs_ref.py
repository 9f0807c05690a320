"""The port's dry run held to the reference's on the same cells.

The reference's production artifact (``repro.launch.dryrun.lower_cell(cfg,
shape, mesh, unroll=False)``, compiled, its ``memory_analysis()``) runs in
a subprocess (``tests/ref_dryrun_auto.py``: a 2x2 or 1x4 mesh of ``Auto``
axes over four host devices; the reference's own mesh has ``Explicit``
axes on jax 0.9, which its sharding constraint refuses); the port's
``dryrun.run_cell`` runs here on a fake group of 4 with the same mesh.
The configs, on the 2x2 mesh: ``tests/test_torch_dryrun.py``'s three
widened smoke configs and two more whose ``wq`` passes the 1 Mi-element
sharding threshold, so that the model axis splits their heads (deepseek's
with KV heads split as the queries, mixtral's with one KV head read by
both model ranks), and one with a vocabulary of 32768, whose loss
backward outweighs its activations; on the 1x4 mesh, two whose heads the
model axis does not divide: 6 attention heads (2 groups of 3) and 6 SSD
heads (2, 2, 2 and none).  The shapes: two train cells, a prefill cell,
and a prefill long enough for the q-chunk loop.

Per cell: equal argument bytes, and the port's temp bytes at most
``TEMP_FACTOR`` x the reference's.  Per config: the port runs attention on
head shards (``layers.head_shards``), and the SSD core on SSD heads
(``layers.ssd_heads``), exactly where the reference's compiled HLO splits
the score tensor's heads and the SSD's quadratic temporaries' heads.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as L
from repro_torch.models import lm

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port's temp bytes over the reference's, at most.  Measured: 0.003-
#: 1.035 (the highest mixtral-8x22b's prefill_q), deepseek-7b-vocab's
#: train_s 0.884 with the optimizer's one pass over every leaf; 1.362
#: with the eager per-leaf AdamW, whose temporaries on the largest leaf
#: set that cell's peak.  The same step with a global-shaped loss
#: backward, batch-only attention heads, four score temporaries and
#: AdamW squaring partial gradients: 1.415-3.620 in eight cells (every
#: prefill_q, deepseek-7b-vocab's train_s and train_l).
TEMP_FACTOR = 1.1
WIDE = dict(d_model=512, d_ff=2048, vocab_size=4096)
#: name -> (arch, overrides of its smoke config, mesh)
CONFIGS = {
    "deepseek-7b": ("deepseek-7b", WIDE, (2, 2)),
    "mixtral-8x22b": ("mixtral-8x22b", WIDE, (2, 2)),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", WIDE, (2, 2)),
    "deepseek-7b-heads": ("deepseek-7b", dict(WIDE, num_heads=8,
                                              num_kv_heads=8, head_dim=128),
                          (2, 2)),
    "mixtral-8x22b-heads": ("mixtral-8x22b", dict(WIDE, num_heads=8,
                                                  num_kv_heads=1,
                                                  head_dim=128), (2, 2)),
    "deepseek-7b-vocab": ("deepseek-7b", dict(WIDE, vocab_size=32768),
                          (2, 2)),
    # 6 / 6 heads of 256 lanes on a 4-way model axis: gcd(6, 4) = 2 groups
    # of 3 heads, as minicpm-2b's 36 heads run in 4 groups of 9 on 16
    "minicpm-2b-gcd": ("minicpm-2b", dict(WIDE, d_model=1536, num_heads=6,
                                          num_kv_heads=6, head_dim=256),
                       (1, 4)),
    # 6 SSD heads of 256 lanes (d_inner 1536, in_proj [768, 3110] and
    # out_proj sharded as mamba2-130m's) on a 4-way model axis: 2, 2, 2
    # and none, as its 24 heads run 2 a device on 16
    "mamba2-130m-ssd": ("mamba2-130m", dict(d_model=768, ssm_head_dim=256,
                                            vocab_size=4096), (1, 4)),
}
SHAPES = (configs.ShapeConfig("train_s", 32, 12, "train"),
          configs.ShapeConfig("train_l", 512, 4, "train"),
          configs.ShapeConfig("prefill_s", 32, 4, "prefill"),
          configs.ShapeConfig("prefill_q", 3 * L.ATTN_Q_CHUNK, 4, "prefill"))
CELLS = [(name, shape) for name in CONFIGS for shape in SHAPES]


def config(name):
    arch, over, _ = CONFIGS[name]
    return dataclasses.replace(configs.get(arch).smoke, **over)


def ssd_heads(rec: dict):
    """The SSD heads a device holds in a reference record's quadratic
    [B, nc, Q, Q, h] / [B, nc, h, Q, Q] temporaries (the fewest any
    holds; ``tests/ref_dryrun_auto.py`` ``ssd_shapes``), or None."""
    quad = rec["ssd"].get("quadratic", [])
    return min(d[4] if d[2] == d[3] else d[2] for d in quad) \
        if quad else None


@pytest.fixture(scope="module")
def results():
    return run_cells()


def run_cells():
    """{(config, shape name): (reference record, port record)}: the
    reference's cells in one subprocess, started first and read after the
    port's cells have run here."""
    import torch.distributed as dist

    spec = [{"arch": CONFIGS[n][0], "smoke": True, "overrides": CONFIGS[n][1],
             "shape": dataclasses.astuple(s), "mesh": list(CONFIGS[n][2])}
            for n, s in CELLS]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(HERE), "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "ref_dryrun_auto.py"),
         "--cells", json.dumps(spec)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        mesh_lib.start_fake_group(4)
        meshes = {shape: mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
                  for shape in {c[2] for c in CONFIGS.values()}}
        port = {(n, s.name): dryrun.run_cell(
            CONFIGS[n][0], s, mesh=meshes[CONFIGS[n][2]], cfg=config(n),
            roofline=False) for n, s in CELLS}
        plans = {n: _plans(config(n), meshes[CONFIGS[n][2]])
                 for n in CONFIGS}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return {c: (r, port[c]) for c, r in zip(
        [(n, s.name) for n, s in CELLS], ref)}, plans


def _plans(cfg, mesh):
    """(``layers.head_shards`` of the config's first attention layer,
    ``layers.ssd_heads`` of its first SSD layer; None where it has none)
    as the dry run places them (fake tensors, nothing allocated)."""
    model = configs.param_specs(cfg)
    model_pl = shd.param_shardings(cfg, model, mesh)
    shapes = {n: p.shape for n, p in model.named_parameters()}

    def leaf(name):
        return shd.distribute(torch.empty(shapes[name]), mesh,
                              model_pl[name])

    with FakeTensorMode():
        x = shd.distribute(torch.empty(4, 8, cfg.d_model), mesh,
                           (Shard(0), Replicate()))
        heads = ssd = None
        if cfg.has_attention:
            heads = L.head_shards(x, leaf("blocks.0.attn.wq"), cfg.num_heads,
                                  cfg.num_kv_heads)
        if cfg.has_ssm:
            ssd = L.ssd_heads(x, leaf("blocks.0.ssm.out_proj"),
                              leaf("blocks.0.ssm.in_proj"),
                              lm.ssm_dims(cfg).nheads)
        return heads, ssd


@pytest.mark.parametrize("name,shape", CELLS,
                         ids=[f"{n}-{s.name}" for n, s in CELLS])
def test_memory_against_reference(results, name, shape):
    ref, port = results[0][(name, shape.name)]
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    ratio = port["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
    assert ratio <= TEMP_FACTOR, (
        f"{name} {shape.name}: port temp {port['memory']['temp_bytes']} B, "
        f"reference {ref['memory']['temp_bytes']} B ({ratio:.3f}x)")


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if config(n).has_attention])
def test_heads_partitioned_as_reference(results, name):
    """Where the reference's per-device score tensor holds fewer heads than
    the layer has, the port runs the core on head shards holding the same
    count (H / m where the model axis divides the heads, H / gcd(H, m)
    elsewhere); else it keeps every head (the batch-only path)."""
    cfg = config(name)
    plan = results[1][name][0]
    for shape in SHAPES:
        ref, _ = results[0][(name, shape.name)]
        assert ref["scores"], f"{name} {shape.name}: no score tensor found"
        heads = math.prod(ref["scores"][0][1:3])
        if heads < cfg.num_heads:
            assert plan is not None and plan.hq == heads, (name, shape.name)
        else:
            assert plan is None, (name, shape.name)
    if name.endswith(("-heads", "-gcd")):
        assert plan is not None


@pytest.mark.parametrize("name", [n for n in CONFIGS if config(n).has_ssm])
def test_ssd_heads_partitioned_as_reference(results, name):
    """Where the reference's per-device quadratic SSD temporaries hold
    fewer heads than the layer has, the port runs the SSD core on as many
    heads a rank (rank 0's share); else it keeps every head."""
    cfg = config(name)
    nheads = lm.ssm_dims(cfg).nheads
    plan = results[1][name][1]
    for shape in SHAPES:
        ref, _ = results[0][(name, shape.name)]
        heads = ssd_heads(ref)
        assert heads is not None, f"{name} {shape.name}: no SSD tensor found"
        if heads < nheads:
            assert plan is not None and \
                len(range(nheads)[plan.heads]) == heads, (
                name, shape.name, heads)
        else:
            assert plan is None, (name, shape.name)
    assert plan is not None


if __name__ == "__main__":
    # every cell's temp bytes, port / reference (run from the repo root
    # with PYTHONPATH=src)
    for (name, shape), (ref, port) in run_cells()[0].items():
        a, b = port["memory"]["temp_bytes"], ref["memory"]["temp_bytes"]
        print(f"{name} {shape}: port {a} B, reference {b} B, {a / b:.4f}x")
