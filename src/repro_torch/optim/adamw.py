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
update and the decayed master.  A parameter whose ``.grad`` is None (one
the loss does not reach: mamba2's ``ln2``) takes a zero gradient, as
``jax.grad`` gives it: its moments and its weight decay still move.

Schedules: cosine (default), WSD (warmup-stable-decay, minicpm
[arXiv:2404.06395]) and const.  ``state_from_numpy`` / ``state_to_numpy``
carry the reference's ``opt_state`` tree (per-layer leaves stacked on a
leading L axis) across.  The reference's ``state_shardings`` (ZeRO-3
placements on a mesh) waits for the mesh, ROADMAP Queue A item 14; on one
device every state leaf sits beside its parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

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


def init(model: torch.nn.Module) -> dict:
    """Optimizer state: a float32 master copy (a real copy, float32
    parameters too), zero moments, step 0 (int32), on the model's
    device."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32 (None
    leaves count zero)."""
    total = None
    for g in grads:
        if g is None:
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, opt_state: dict,
           model: torch.nn.Module):
    """One AdamW step on ``grads`` ({name: gradient or None}), in place.
    Returns (model, opt_state, {"grad_norm", "lr"}) with the metrics as
    float32 0-d tensors (no host sync)."""
    step = opt_state["step"]
    step += 1
    f32 = torch.float32
    s = step.to(f32)
    lr = schedule_fn(cfg)(step)

    gnorm = global_norm(grads.values())
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.full_like(s, b1), s)
    bc2 = 1 - torch.pow(torch.full_like(s, b2), s)

    # each line is the reference's expression, rounded in the same order:
    #   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
    #   master = master - lr * ((m / bc1) / (sqrt(v / bc2) + eps)
    #                           + weight_decay * master)
    for name, p in model.named_parameters():
        m, v, w = (opt_state[k][name] for k in ("m", "v", "master"))
        g = grads[name]
        g = (torch.zeros_like(w) if g is None
             else g.to(f32, copy=True)).mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        sq = (g * (1 - b2)).mul_(g)
        v.mul_(b2).add_(sq)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(w * cfg.weight_decay)
        w.sub_(upd.mul_(lr))
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
