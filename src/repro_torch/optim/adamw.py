"""AdamW with float32 master weights and the reference's schedules.

Counterpart of ``repro/optim/adamw.py``.  The state is a dict of dicts
keyed by parameter name (``model.named_parameters()``)::

    {"master": {name: float32}, "m": {name: float32},
     "v": {name: float32}, "step": int32 0-d tensor}

and ``update`` works in place: the moments, the masters and the step
counter are rewritten, and each parameter takes its master cast back to
its dtype, so a step holds no second copy of the model or its state.  The
arithmetic is the reference's, operation for operation in float32 (the
schedule and the bias corrections too, on the device): the clip scale
from the global norm, then per leaf ``m``, ``v``, the bias-corrected
update and the decayed master.  The two passes over the leaves (the norm,
the update) are the ops of ``kernels/adamw.py``: one hand-written CUDA
kernel pass each on the card, the plain torch version on the CPU.  A
parameter whose ``.grad`` is None (one the loss does not reach: mamba2's
``ln2``) takes a zero gradient, as ``jax.grad`` gives it: its moments and
its weight decay still move.

Schedules: cosine (default), WSD (warmup-stable-decay, minicpm
[arXiv:2404.06395]) and const.  ``state_from_numpy`` / ``state_to_numpy``
carry the reference's ``opt_state`` tree (per-layer leaves stacked on a
leading L axis) across.

On a mesh the parameters are DTensors (``dist.sharding``) and
``state_shardings`` gives the state's placements, ZeRO-3 included:
``init(model, shardings)`` lays each state leaf out on them, and
``update`` runs on their local tensors: each gradient is reduced into
its master's placements (a reduce-scatter of a partial sum) before the
passes read it, the local sums of squares are summed over the mesh dims
that shard them, and the master -> parameter copy all-gathers a
ZeRO-sharded master into its replicated parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist import sharding as shd
from repro_torch.kernels import adamw as kadamw
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: fraction of steps in decay phase


def schedule_fn(cfg: AdamWConfig) -> Callable:
    """step (an integer tensor) -> the learning rate, a float32 tensor on
    the step's device, computed in float32 as the reference does."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "const":
            return cfg.lr * warm
        if cfg.schedule == "cosine":
            t = torch.clamp(
                (s - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * t)))
        if cfg.schedule == "wsd":
            decay_start = cfg.total_steps * (1 - cfg.decay_frac)
            in_decay = s > decay_start
            t = torch.clamp(
                (s - decay_start) / max(cfg.total_steps - decay_start, 1),
                0.0, 1.0)
            # MiniCPM: stable LR, then exponential-ish anneal to ~0.1 lr
            return cfg.lr * warm * torch.where(
                in_decay, torch.pow(0.1, t), torch.ones_like(t))
        raise ValueError(cfg.schedule)

    return fn


def init(model: torch.nn.Module, shardings: dict | None = None) -> dict:
    """Optimizer state: a float32 master copy (a real copy, float32
    parameters too), zero moments, step 0 (int32), on the model's
    device.  ``shardings`` (``state_shardings``' output) places the
    master and the moments of a DTensor model: a ZeRO-sharded leaf keeps
    only its rank's slice (taken locally, no collective)."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def master(n, p):
        w = p.detach().to(torch.float32, copy=True)
        if shardings is not None and isinstance(w, DTensor):
            w = w.redistribute(w.device_mesh, shardings["master"][n])
        return w

    masters = {n: master(n, p) for n, p in params.items()}
    return {
        "master": masters,
        "m": {n: torch.zeros_like(w) for n, w in masters.items()},
        "v": {n: torch.zeros_like(w) for n, w in masters.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32 (None
    leaves count zero): the ``adamw_sumsq`` pass, plain on the CPU."""
    grads = [g for g in grads if g is not None]
    return torch.sqrt(kadamw.sumsq(grads))


def _sumsq(groups: dict, mesh) -> torch.Tensor:
    """The global sum of squares from each rank's local gradients,
    grouped by the mesh dims that shard them (one group, (), off a mesh):
    each group's local sum is summed over exactly those dims (a
    replicated dim holds the same elements on every rank, so each element
    counts once)."""
    total = None
    for dims, gs in groups.items():
        sq = kadamw.sumsq(gs)
        if dims:
            sq = DTensor.from_local(
                sq, mesh, [Partial() if d in dims else Replicate()
                           for d in range(mesh.ndim)],
                run_check=False).full_tensor()
        total = sq if total is None else total + sq
    return total


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, sq: torch.Tensor):
    """The step's float32 0-d scalars on the device, computed as the
    reference does: (grad norm, clip scale, lr, bc1, bc2) from the
    advanced ``step`` and the gradients' sum of squares ``sq``."""
    s = step.to(torch.float32)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.full_like(s, cfg.b1), s)
    bc2 = 1 - torch.pow(torch.full_like(s, cfg.b2), s)
    return gnorm, scale, schedule_fn(cfg)(step), bc1, bc2


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, opt_state: dict,
           model: torch.nn.Module):
    """One AdamW step on ``grads`` ({name: gradient or None}), in place.
    Returns (model, opt_state, {"grad_norm", "lr"}) with the metrics as
    float32 0-d tensors (no host sync).

    Two passes over every leaf (``kernels/adamw.py``): the sum of squares,
    then the update, each one kernel launch on the card whatever the leaf
    count.  On a mesh both run on each rank's local tensors: a gradient is
    first reduced into its master's placements (the square must be of the
    sum, as the reference's partitioner reduces it: partial squares can
    sum below 0), and a parameter whose placements differ from its
    master's (ZeRO-3) takes the master by a DTensor copy (an all-gather)
    after the pass."""
    step = opt_state["step"]
    step += 1
    f32 = torch.float32

    leaves, gathers, groups, mesh = [], [], {}, None
    for name, p in model.named_parameters():
        m, v, w = (opt_state[k][name] for k in ("m", "v", "master"))
        g = grads[name]
        dims = ()
        if isinstance(w, DTensor):
            mesh = w.device_mesh
            if g is not None:
                if g.placements != w.placements:
                    g = g.to(f32).redistribute(mesh, w.placements)
                g = g.to_local()
            dims = tuple(d for d, pl in enumerate(w.placements)
                         if pl.is_shard())
            if p.placements == w.placements:
                p = p.to_local()
            else:
                gathers.append((p, w))
                p = None
            m, v, w = m.to_local(), v.to_local(), w.to_local()
        if g is not None:
            groups.setdefault(dims, []).append(g)
        leaves.append((g, m, v, w, p))

    sq = _sumsq(groups, mesh) if groups else \
        torch.zeros((), dtype=f32, device=step.device)
    gnorm, scale, lr, bc1, bc2 = step_scalars(cfg, step, sq)
    kadamw.adamw_step_(*map(list, zip(*leaves)), scale, lr, bc1, bc2,
                       cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    for p, w in gathers:
        p.copy_(w)
    return model, opt_state, {"grad_norm": gnorm, "lr": lr}


def state_to_numpy(model: torch.nn.Module, opt_state: dict) -> dict:
    """The port's state -> the reference's ``opt_state`` tree (numpy:
    float32 moments and masters, ``step`` int32)."""
    out = {k: lm.to_tree(model, {n: t.detach().cpu().numpy()
                                 for n, t in opt_state[k].items()})
           for k in ("master", "m", "v")}
    out["step"] = opt_state["step"].detach().cpu().numpy()
    return out


def state_from_numpy(model: torch.nn.Module, tree: dict) -> dict:
    """The reference's ``opt_state`` tree (numpy leaves) -> the port's
    state on the model's device."""
    dev = next(model.parameters()).device
    out = {k: {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
               for n, a in lm.from_tree(model, tree[k]).items()}
           for k in ("master", "m", "v")}
    out["step"] = torch.tensor(np.asarray(tree["step"]), dtype=torch.int32,
                               device=dev)
    return out


# ---------------------------------------------------------------------------
# placements on a mesh (ZeRO-3)
# ---------------------------------------------------------------------------

ZERO_MIN_ELEMS = 1 << 20


def zero_rule(shape, mesh):
    """The reference's ZeRO loop on one (stacked) leaf: the *first*
    dimension that the whole mesh divides goes over every axis, or else
    the first that the last axis divides goes over that axis (its comment
    says "largest"; the loop takes the first).  -> (dim, mesh dims) or
    None."""
    world = mesh.size()
    last = mesh.size(mesh.ndim - 1)
    for i, d in enumerate(shape):
        if d % world == 0:
            return i, tuple(range(mesh.ndim))
        if d % last == 0:
            return i, (mesh.ndim - 1,)
    return None


def _per_layer_dim(shape, mesh_dims, mesh):
    """The first per-layer dimension that the mesh dims ``mesh_dims``
    divide (the stacked leaf's rule picked its L axis)."""
    n = 1
    for m in mesh_dims:
        n *= mesh.size(m)
    for i, d in enumerate(shape):
        if d % n == 0:
            return i
    return None


def state_shardings(param_placements: dict, mesh, params=None) -> dict:
    """Optimizer-state placements: {"master", "m", "v": {name:
    placements}, "step": replicated}.

    Default: every state leaf takes its parameter's placements.  ZeRO
    extension: with ``params`` (the ``LM``, or its ``param_specs``), a
    leaf whose parameter is replicated and whose stacked leaf holds at
    least 1 Mi elements gets its state sharded by ``zero_rule``, judged on
    the stacked leaf as the reference does.  Where that rule picks the
    stacked L axis (a data-only mesh whose size divides the layer count),
    a per-layer tensor cannot take it: each layer's state is sharded on
    its first dimension that the same mesh axes divide, the same bytes
    per device."""
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    if params is None:
        tree = dict(param_placements)
    else:
        tree = {}
        for keys, (shape, names, stacked) in shd.stacked_leaves(
                params).items():
            pl = param_placements[names[0]]
            rule = None
            if all(isinstance(p, Replicate) for p in pl) and \
                    math.prod(shape) >= ZERO_MIN_ELEMS:
                rule = zero_rule(shape, mesh)
            if rule is not None:
                dim, mdims = rule
                if stacked:
                    dim = (dim - 1 if dim > 0 else
                           _per_layer_dim(shape[1:], mdims, mesh))
                if dim is not None:
                    pl = tuple(Shard(dim) if m in mdims else Replicate()
                               for m in range(mesh.ndim))
            tree.update({n: pl for n in names})
    return {"master": tree, "m": tree, "v": tree, "step": rep}

