"""Eviction policies over per-way metadata (torch).

Counterpart of ``repro/core/policies.py``: every policy keeps two int32
lanes per way (``meta_a``, ``meta_b``) and the victim is the argmin of
``victim_scores`` over the k ways of one set.  Scores are float32 and
round exactly as the reference's XLA ops do:

  * RANDOM is ``float32(hash_u32(key ^ now, 0xBADA))``: round-to-nearest
    from the uint32 value (held in int64 here, which converts the same);
  * HYPERBOLIC is ``a / (float32(now - b) + 1)`` with IEEE division, the
    int32 subtraction wrapping as in the reference.
"""
from __future__ import annotations

import enum

import torch

from repro_torch.core import hashing


class Policy(enum.IntEnum):
    LRU = 0
    LFU = 1
    FIFO = 2
    RANDOM = 3
    HYPERBOLIC = 4

    @staticmethod
    def parse(name: str) -> "Policy":
        return Policy[name.upper()]


def victim_scores(policy: int, meta_a: torch.Tensor, meta_b: torch.Tensor,
                  now: torch.Tensor, stored_keys: torch.Tensor) -> torch.Tensor:
    """float32 scores, lower evicts sooner.  ``now`` is the int32 logical
    clock (broadcastable); ``stored_keys`` feeds RANDOM's stateless
    per-epoch hash."""
    if policy in (Policy.LRU, Policy.LFU, Policy.FIFO):
        return meta_a.to(torch.float32)
    if policy == Policy.RANDOM:
        now = torch.as_tensor(now, device=stored_keys.device)
        h = hashing.hash_u32(hashing.as_u32(stored_keys) ^ hashing.as_u32(now),
                             seed=0xBADA)
        return h.to(torch.float32)
    if policy == Policy.HYPERBOLIC:
        now = torch.as_tensor(now, dtype=torch.int32, device=meta_b.device)
        age = (now - meta_b).to(torch.float32) + 1.0
        return meta_a.to(torch.float32) / age
    raise ValueError(f"unknown policy {policy}")


def on_hit(policy: int, meta_a: torch.Tensor, meta_b: torch.Tensor,
           now: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Metadata transition on a cache hit."""
    if policy == Policy.LRU:
        now = torch.as_tensor(now, dtype=meta_a.dtype, device=meta_a.device)
        return now.expand(meta_a.shape).clone(), meta_b
    if policy in (Policy.LFU, Policy.HYPERBOLIC):
        return meta_a + 1, meta_b
    if policy in (Policy.FIFO, Policy.RANDOM):
        return meta_a, meta_b
    raise ValueError(f"unknown policy {policy}")


def on_insert(policy: int, now: torch.Tensor, shape: tuple[int, ...] = (),
              device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh metadata for a newly admitted key."""
    if isinstance(now, torch.Tensor) and device is None:
        device = now.device
    now_arr = torch.as_tensor(now, dtype=torch.int32,
                              device=device).expand(shape).clone()
    one = torch.ones(shape, dtype=torch.int32, device=device)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    if policy in (Policy.LRU, Policy.FIFO):
        return now_arr, zero
    if policy == Policy.LFU:
        return one, zero
    if policy == Policy.RANDOM:
        return zero, zero
    if policy == Policy.HYPERBOLIC:
        return one, now_arr  # (n=1, t0=now)
    raise ValueError(f"unknown policy {policy}")


# ---------------------------------------------------------------------------
# Dynamic dispatch: the policy as a tensor.
#
# The functions above branch on ``policy`` in Python.  The sweep runner
# (``repro_torch/eval/runner.py``) stacks same-shape configurations with
# different policies into one step (one CUDA graph on the card), so there
# the policy is data: each ``_dyn`` form evaluates the transitions of the
# candidate ``policies`` (cheap, elementwise) and selects by ``policy_idx``
# with ``torch.where``, bit for bit the static form of the selected policy.
# A caller that knows which policies its lanes hold passes just those (a
# lane whose index is not among them gets 0, as ``jnp.select``'s default).
# ---------------------------------------------------------------------------

def _select(policy_idx: torch.Tensor, branches: dict) -> torch.Tensor:
    """``branches[p]`` where ``policy_idx == p`` (broadcasting), 0 where no
    candidate matches."""
    vals = list(branches.values())
    out = torch.zeros_like(torch.broadcast_tensors(policy_idx, *vals)[1])
    for p, v in reversed(branches.items()):
        out = torch.where(policy_idx == int(p), v, out)
    return out


def _select_pair(policy_idx: torch.Tensor, pairs: dict):
    return (_select(policy_idx, {p: a for p, (a, _) in pairs.items()}),
            _select(policy_idx, {p: b for p, (_, b) in pairs.items()}))


def victim_scores_dyn(policy_idx: torch.Tensor, meta_a: torch.Tensor,
                      meta_b: torch.Tensor, now: torch.Tensor,
                      stored_keys: torch.Tensor,
                      policies=tuple(Policy)) -> torch.Tensor:
    """``victim_scores`` with ``policy_idx`` an int tensor broadcastable to
    the metadata, over the candidate ``policies``."""
    return _select(policy_idx, {p: victim_scores(p, meta_a, meta_b, now,
                                                 stored_keys)
                                for p in policies})


def on_hit_dyn(policy_idx: torch.Tensor, meta_a: torch.Tensor,
               meta_b: torch.Tensor, now: torch.Tensor,
               policies=tuple(Policy)):
    """``on_hit`` with ``policy_idx`` as a tensor."""
    return _select_pair(policy_idx, {p: on_hit(p, meta_a, meta_b, now)
                                     for p in policies})


def on_insert_dyn(policy_idx: torch.Tensor, now: torch.Tensor,
                  shape: tuple[int, ...] = (), device=None,
                  policies=tuple(Policy)):
    """``on_insert`` with ``policy_idx`` as a tensor."""
    if device is None and isinstance(policy_idx, torch.Tensor):
        device = policy_idx.device
    return _select_pair(policy_idx, {p: on_insert(p, now, shape, device)
                                     for p in policies})
