"""The port's dry run held to the reference's on the same cells.

The reference's production artifact (``repro.launch.dryrun.lower_cell(cfg,
shape, mesh, unroll=False)``, compiled, its ``memory_analysis()``) runs in
a subprocess (``tests/ref_dryrun_auto.py``: a 2x2 mesh of ``Auto`` axes
over four host devices; the reference's own mesh has ``Explicit`` axes on
jax 0.9, which its sharding constraint refuses); the port's
``dryrun.run_cell`` runs here on a fake 2x2 group.  The configs are
``tests/test_torch_dryrun.py``'s three widened smoke configs and two more
whose ``wq`` passes the 1 Mi-element sharding threshold, so that the model
axis splits their heads (deepseek's with KV heads split as the queries,
mixtral's with one KV head read by both model ranks), and one with a
vocabulary of 32768, whose loss backward outweighs its activations; the
shapes two train cells, a prefill cell, and a prefill long enough for the
q-chunk loop.

Per cell: equal argument bytes, and the port's temp bytes at most
``TEMP_FACTOR`` x the reference's.  Per config: the port runs attention on
head shards (``layers.head_shards``) exactly where the reference's compiled
HLO splits the score tensor's heads.
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

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port's temp bytes over the reference's, at most.  Measured: 0.003-
#: 1.035, and 1.362 in deepseek-7b-vocab's train_s cell, whose peak is
#: the eager AdamW's per-leaf temporaries on its largest leaf.  The same
#: step with a global-shaped loss backward, batch-only attention heads,
#: four score temporaries and AdamW squaring partial gradients: 1.415-
#: 3.620 in eight cells (every prefill_q, deepseek-7b-vocab's train_s and
#: train_l).
TEMP_FACTOR = 1.4
WIDE = dict(d_model=512, d_ff=2048, vocab_size=4096)
#: name -> (arch, overrides of its smoke config)
CONFIGS = {
    "deepseek-7b": ("deepseek-7b", WIDE),
    "mixtral-8x22b": ("mixtral-8x22b", WIDE),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", WIDE),
    "deepseek-7b-heads": ("deepseek-7b", dict(WIDE, num_heads=8,
                                              num_kv_heads=8, head_dim=128)),
    "mixtral-8x22b-heads": ("mixtral-8x22b", dict(WIDE, num_heads=8,
                                                  num_kv_heads=1,
                                                  head_dim=128)),
    "deepseek-7b-vocab": ("deepseek-7b", dict(WIDE, vocab_size=32768)),
}
SHAPES = (configs.ShapeConfig("train_s", 32, 12, "train"),
          configs.ShapeConfig("train_l", 512, 4, "train"),
          configs.ShapeConfig("prefill_s", 32, 4, "prefill"),
          configs.ShapeConfig("prefill_q", 3 * L.ATTN_Q_CHUNK, 4, "prefill"))
CELLS = [(name, shape) for name in CONFIGS for shape in SHAPES]


def config(name):
    arch, over = CONFIGS[name]
    return dataclasses.replace(configs.get(arch).smoke, **over)


@pytest.fixture(scope="module")
def results():
    """{(config, shape name): (reference record, port record)}: the
    reference's cells in one subprocess, started first and read after the
    port's cells have run here."""
    import torch.distributed as dist

    spec = [{"arch": CONFIGS[n][0], "smoke": True, "overrides": CONFIGS[n][1],
             "shape": dataclasses.astuple(s), "mesh": [2, 2]}
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
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
        port = {(n, s.name): dryrun.run_cell(CONFIGS[n][0], s, mesh=mesh,
                                             cfg=config(n), roofline=False)
                for n, s in CELLS}
        plans = {n: _head_plan(config(n), mesh) for n in CONFIGS}
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


def _head_plan(cfg, mesh):
    """``layers.head_shards`` of the config's first attention layer as the
    dry run places it (fake tensors, nothing allocated)."""
    model_pl = shd.param_shardings(cfg, configs.param_specs(cfg), mesh)
    with FakeTensorMode():
        x = shd.distribute(torch.empty(4, 8, cfg.d_model), mesh,
                           (Shard(0), Replicate()))
        wq = shd.distribute(torch.empty(cfg.d_model,
                                        cfg.num_heads * cfg.hd),
                            mesh, model_pl["blocks.0.attn.wq"])
        return L.head_shards(x, wq, cfg.num_heads, cfg.num_kv_heads)


@pytest.mark.parametrize("name,shape", CELLS,
                         ids=[f"{n}-{s.name}" for n, s in CELLS])
def test_memory_against_reference(results, name, shape):
    ref, port = results[0][(name, shape.name)]
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    ratio = port["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
    assert ratio <= TEMP_FACTOR, (
        f"{name} {shape.name}: port temp {port['memory']['temp_bytes']} B, "
        f"reference {ref['memory']['temp_bytes']} B ({ratio:.3f}x)")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_heads_partitioned_as_reference(results, name):
    """Where the reference's per-device score tensor holds fewer heads than
    the layer has, the port runs the core on head shards holding the same
    count; elsewhere it keeps every head (the batch-only path)."""
    cfg = config(name)
    plan = results[1][name]
    for shape in SHAPES:
        ref, _ = results[0][(name, shape.name)]
        assert ref["scores"], f"{name} {shape.name}: no score tensor found"
        heads = math.prod(ref["scores"][0][1:3])
        if heads < cfg.num_heads:
            assert plan is not None and plan.hq == heads, (name, shape.name)
        else:
            assert plan is None, (name, shape.name)
    if name.endswith("-heads"):
        assert plan is not None
