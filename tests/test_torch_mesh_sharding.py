"""The port's meshes and sharding rules against the reference's.

The production meshes (16x16 and 2x16x16) are DeviceMeshes over torch's
fake process group in this one process; the reference's rules run on a
``jax.sharding.AbstractMesh`` of the same shape, so no device of either
package is needed.  Every leaf of every architecture's full config is
compared: parameters (judged on the stacked leaf), inputs, caches and the
ZeRO optimizer-state placements.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.dist import sharding as ref_shd
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw

ARCHS = configs.ARCH_IDS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "data4": ((4, 1), ("data", "model"))}


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(port DeviceMesh, reference AbstractMesh) on a fake group of the
    mesh's size, destroyed after the module."""
    import torch.distributed as dist

    shape, names = MESHES[request.param]
    mesh_lib.start_fake_group(int(np.prod(shape)))
    if request.param == "data4":
        mesh = mesh_lib.make_dev_mesh(4, 1, device_type="cpu")
    else:
        mesh = mesh_lib.make_production_mesh(
            multi_pod=request.param == "multi", device_type="cpu")
    yield mesh, AbstractMesh(shape, names)
    if dist.is_initialized():
        dist.destroy_process_group()


def to_pspec(placements, mesh, ndim: int) -> tuple:
    """Placements -> the reference's ``PartitionSpec`` entries for a
    tensor of ``ndim`` dimensions (a tuple of axis names where one
    dimension spans several mesh axes; trailing Nones dropped)."""
    dims = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a)
            for a in dims]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _norm(spec) -> tuple:
    """A PartitionSpec's entries, trailing Nones dropped."""
    out = [tuple(a) if isinstance(a, (tuple, list)) else a for a in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _stacked_specs(model, placements, mesh) -> dict:
    """Port placements -> {reference key path: PartitionSpec entries} of
    the stacked leaf (a per-layer placement shifted onto [L, ...])."""
    out = {}
    for keys, (shape, names, stacked) in shd.stacked_leaves(model).items():
        pl = placements[names[0]]
        assert all(placements[n] == pl for n in names), keys
        out[keys] = to_pspec(shd.shift(pl, 1) if stacked else pl, mesh,
                                 len(shape))
    return out


def test_production_mesh_shapes(meshes):
    mesh, ref = meshes
    assert tuple(mesh.shape) == tuple(ref.shape.values())
    assert tuple(mesh.mesh_dim_names) == tuple(ref.axis_names)
    assert mesh.device_type == "cpu"


def test_mesh_size_must_match_world(meshes):
    mesh, _ = meshes
    with pytest.raises(ValueError, match="ranks; the process group has"):
        mesh_lib.make_mesh((3, 5), ("data", "model"), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_placements_match_reference(meshes, arch):
    mesh, ref = meshes
    cfg = configs.get(arch).config
    rcfg = ref_configs.get(arch).config
    model = configs.param_specs(cfg)
    pl = shd.param_shardings(cfg, model, mesh)
    rspecs = ref_configs.param_specs(rcfg)
    rpl = ref_shd.param_shardings(rcfg, rspecs, ref)
    want = {k: _norm(v.spec) for k, v in _flat(rpl).items()}
    assert _stacked_specs(model, pl, mesh) == want

    st = adamw.state_shardings(pl, mesh, model)
    rst = ref_adamw.state_shardings(rpl, ref, rspecs)
    assert st["step"] == shd.replicated(mesh)
    want = {k: _norm(v.spec) for k, v in _flat(rst["master"]).items()}
    got = _stacked_specs(model, st["master"], mesh)
    leaves = shd.stacked_leaves(model)
    # where the reference's ZeRO rule picks a stacked leaf's L axis
    moved = {k for k, v in want.items()
             if leaves[k][2] and v and v[0] is not None}
    for k in ("m", "v"):
        assert st[k] == st["master"]
    # the one documented difference: there each layer is sharded on its
    # first dimension that the same mesh axes divide, the same bytes per
    # device
    for keys in moved:
        assert want[keys][0] is not None            # the reference: L axis
        axes = want[keys][0]
        axes = axes if isinstance(axes, tuple) else (axes,)
        per_layer = got[keys]
        assert per_layer[0] is None                 # the port: not L
        shape = leaves[keys][0]
        sharded = [(d, a) for d, a in enumerate(per_layer) if a is not None]
        assert len(sharded) == 1
        d, a = sharded[0]
        assert (a if isinstance(a, tuple) else (a,)) == axes
        n = int(np.prod([ref.shape[x] for x in axes]))
        assert shape[d] % n == 0
    assert {k: v for k, v in got.items() if k not in moved} == \
        {k: v for k, v in want.items() if k not in moved}
    if mesh.size() == 256:
        # the production single pod: some leaf of every arch is sharded
        assert any(any(isinstance(p, Shard) for p in v) for v in pl.values())
    if mesh.size() == 4 and arch == "hymba-1.5b":
        # a data-only mesh of 4 divides hymba's 32 layers: the reference
        # shards the replicated wq's state on L, the port each layer's
        # [1600, 1600] on dim 0, over every mesh axis
        assert ("blocks", "attn", "wq") in moved
        assert st["master"]["blocks.0.attn.wq"] == (Shard(0), Shard(0))
        assert all(isinstance(p, Replicate) for p in pl["blocks.0.attn.wq"])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_placements_match_reference(meshes, arch):
    mesh, ref = meshes
    cfg = configs.get(arch).config
    rcfg = ref_configs.get(arch).config
    spec = configs.get(arch)
    for sc in list(spec.shapes()):
        rsc = ref_configs.SHAPES_BY_NAME[sc.name]
        isp = configs.input_specs(cfg, sc)
        got = {k: to_pspec(v, mesh, isp[k].dim())
               for k, v in shd.input_shardings(cfg, sc, isp, mesh).items()}
        rin = ref_shd.input_shardings(rcfg, rsc,
                                      ref_configs.input_specs(rcfg, rsc), ref)
        assert got == {k: _norm(v.spec) for k, v in rin.items()}, sc.name
        assert to_pspec(shd.batch_pspec(cfg, sc.global_batch, mesh),
                            mesh, 1) == _norm(ref_shd.batch_pspec(
                                rcfg, rsc.global_batch, ref))
        if sc.kind != "decode":
            continue
        csp = configs.cache_specs(cfg, sc)
        got = {k: to_pspec(v, mesh, csp[k].dim())
               for k, v in shd.cache_shardings(cfg, sc, csp, mesh).items()}
        rc = ref_shd.cache_shardings(
            rcfg, rsc, jax.eval_shape(lambda: ref_configs.cache_specs(
                rcfg, rsc)), ref)
        assert got == {k: _norm(v.spec) for k, v in rc.items()}, sc.name
