"""Sharding rules for the launch drivers (train / dryrun) as DTensor
placements.

Counterpart of ``repro/dist/sharding.py``.  The mesh carries a ``data``
axis (plus an optional leading ``pod`` axis, ``launch/mesh.py``) for batch
parallelism and a ``model`` axis for tensor parallelism.  The rules are
the reference's, shape-driven:

  * params: replicate small leaves; a leaf of at least 1 Mi elements is
    sharded on its largest dimension divisible by the ``model`` axis.
    Leaves with no such dimension stay replicated (their optimizer state
    is then ZeRO-sharded by ``optim.adamw.state_shardings``);
  * inputs: batch-shard the leading dimension over the data axes when it
    divides; everything else replicated;
  * caches: decode caches are [layers, batch, ...]; batch-shard dim 1.

Every function returns placements: a tuple with one ``Shard(d)`` or
``Replicate()`` per mesh dimension, in the mesh's axis order (a leaf
sharded over ``("pod", "data")`` is ``Shard(0)`` on both).  The reference
returns ``NamedSharding``s of ``PartitionSpec``s.

The reference stacks each layer's parameters on a leading L axis; the
port keeps one tensor per layer (``models.lm.tree_paths``).  The rule is
judged on the stacked leaf, as the reference sees it (its size decides the
threshold, its shape the dimension), and each layer's tensor takes that
placement with the dimension shifted by one.  A rule that picks the L axis
raises with the leaf's name (no architecture does on the production
meshes).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models import lm

MIN_SHARD_ELEMS = 1 << 20
#: the mesh axes that shard the batch (the model's ``layers.batch_only``
#: keeps its activations sharded over these alone)
DATA_AXES = ("pod", "data")


def data_axes(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in axes) if axes else 1


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in range(mesh.ndim))


def to_placements(dims, mesh) -> tuple:
    """Per-tensor-dimension spec (None, an axis name or a tuple of names:
    a ``PartitionSpec``'s entries) -> placements on ``mesh``."""
    out = [Replicate()] * mesh.ndim
    for d, axes in enumerate(dims):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def shift(placements, by: int) -> tuple:
    """Placements of a stacked leaf -> those of one layer's slice
    (``by=-1``), or back (``by=1``)."""
    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p
                 for p in placements)


def batch_pspec(cfg, global_batch: int, mesh) -> tuple:
    """Placements of a leading batch dimension."""
    axes = data_axes(mesh)
    n = axis_size(mesh, axes)
    if n > 1 and global_batch % n == 0:
        return to_placements((axes if len(axes) > 1 else axes[0],), mesh)
    return replicated(mesh)


def _shard_leading(shape, mesh, dim: int) -> tuple:
    axes = data_axes(mesh)
    n = axis_size(mesh, axes)
    dims = [None] * len(shape)
    if n > 1 and len(shape) > dim and shape[dim] % n == 0:
        dims[dim] = axes if len(axes) > 1 else axes[0]
    return to_placements(dims, mesh)


def stacked_leaves(model: nn.Module) -> dict:
    """{reference key path: (stacked shape, [parameter names], stacked)}
    of a port ``LM``: a per-layer leaf stacks its layers' tensors on a
    leading L axis, as the reference's tree holds it."""
    params = dict(model.named_parameters())
    out = {}
    for name, keys, i in lm.tree_paths(model):
        shape = tuple(params[name].shape)
        if keys not in out:
            out[keys] = [shape, [], i is not None]
        out[keys][1].append(name)
    return {k: ((len(names), *shape) if stacked else shape, names, stacked)
            for k, (shape, names, stacked) in out.items()}


def param_rule(shape, mesh) -> tuple:
    """The reference's rule on one (stacked) leaf -> its placements."""
    m = (mesh.size(mesh.mesh_dim_names.index("model"))
         if "model" in mesh.mesh_dim_names else 1)
    if m == 1 or math.prod(shape) < MIN_SHARD_ELEMS or not shape:
        return replicated(mesh)
    cand = [(d, i) for i, d in enumerate(shape) if d % m == 0]
    if not cand:
        return replicated(mesh)          # dp_only leaf: ZeRO handles it
    _, i = max(cand)                     # largest divisible dimension wins
    dims = [None] * len(shape)
    dims[i] = "model"
    return to_placements(dims, mesh)


def param_shardings(cfg, model: nn.Module, mesh) -> dict:
    """Tensor-parallel placements over the ``model`` axis:
    {parameter name: placements}, each judged on the stacked leaf."""
    out = {}
    for keys, (shape, names, stacked) in stacked_leaves(model).items():
        pl = param_rule(shape, mesh)
        if stacked:
            if any(isinstance(p, Shard) and p.dim == 0 for p in pl):
                raise ValueError(
                    f"{'.'.join(keys)}: the sharding rule picks the "
                    f"stacked layer axis of {shape}, which per-layer "
                    "tensors cannot take")
            pl = shift(pl, -1)
        out.update({n: pl for n in names})
    return out


def input_shardings(cfg, shape, ispecs: dict, mesh) -> dict:
    """Batch-shard every input's leading dimension over the data axes."""
    return {k: _shard_leading(tuple(v.shape), mesh, 0)
            for k, v in ispecs.items()}


def cache_shardings(cfg, shape, cspecs: dict, mesh) -> dict:
    """Decode caches are [layers, batch, ...]: batch-shard dimension 1
    (``cross_len`` [B] stays replicated, as in the reference)."""
    return {k: _shard_leading(tuple(v.shape), mesh, 1)
            for k, v in cspecs.items()}


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------

def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same full tensor on every rank) -> a DTensor on
    ``placements``: each rank keeps its own slice, with no collective."""
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute_tree(tree: dict, mesh, placements: dict) -> dict:
    return {k: distribute(v, mesh, placements[k]) for k, v in tree.items()}


def distribute_model(model: nn.Module, mesh, placements: dict) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor on its placements
    (in place; ``requires_grad`` kept) and return the model."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(
            distribute(p.detach(), mesh, placements[name]),
            requires_grad=p.requires_grad))
    return model


def local_bytes(t) -> int:
    """Bytes of this rank's part of ``t`` (a DTensor's local shard)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()
