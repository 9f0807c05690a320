"""Request router of the set-sharded layer: set-owner bucketing on tensors.

Counterpart of ``repro/core/router.py``.  The owner of a key is the HIGH
``log2(D)`` bits of its global set index (``owner = gset // (S/D)``); the
low bits are the shard-local set index, so each shard probes with the same
hash unchanged.  A batch of B requests is bucketed into a fixed
``[D, capacity]`` layout by one stable sort on the owner id: arrival order
is kept inside each bucket, which is what makes the sharded cache equal to
the unsharded one for the timestamp-order-invariant policies.  Lanes
ranked past ``capacity`` in their bucket are *deferred*: reported in
``RoutePlan.deferred``, never silently dropped.  ``unscatter`` inverts the
permutation.

Everything here is tensor ops with fixed shapes and no host sync: the
scatters of un-routed lanes go to a sink slot one past the end, which is
sliced off (the reference's ``mode="drop"``), and no boolean index or
``nonzero`` is used.  Every function takes a batch on its last dimension,
so ``route`` and ``bucket`` also route all chunks of a ``[steps, B]``
trace in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing


@dataclasses.dataclass
class RoutePlan:
    """Where every request of a batch goes: shard ``owner``, arrival rank
    ``pos`` inside that shard's bucket, and the overflow-``deferred`` mask.
    Tensors of the batch's shape ([B], or [steps, B] for a whole trace)."""

    owner: torch.Tensor     # int32: owning shard (high bits of gset)
    pos: torch.Tensor       # int32: arrival rank within the owner bucket
    deferred: torch.Tensor  # bool: ranked past capacity, not routed
    enabled: torch.Tensor   # bool: the caller's lane mask (pre-defer)

    @property
    def routed(self) -> torch.Tensor:
        """Lanes that actually land in a bucket this step."""
        return self.enabled & ~self.deferred


def pad_chunks(trace: np.ndarray, batch: int):
    """Chunk a trace for batched replay, padding the trailing
    ``len % batch`` requests into a disabled-lane tail chunk (no request is
    silently dropped) -> (chunks [steps, B] uint32, enabled [steps, B]
    bool), as host arrays.
    """
    trace = np.asarray(trace, np.uint32)
    n = trace.shape[0]
    steps = -(-n // batch)
    padded = np.zeros((steps * batch,), np.uint32)
    padded[:n] = trace
    enabled = np.zeros((steps * batch,), bool)
    enabled[:n] = True
    return padded.reshape(steps, batch), enabled.reshape(steps, batch)


def owner_of(keys: torch.Tensor, num_sets: int, num_shards: int,
             seed: int) -> torch.Tensor:
    """Owning shard per key (int32 bit patterns of the raw uint32 keys):
    the high bits of the global set index.  int32, the keys' shape."""
    gset = hashing.set_index(keys, num_sets, seed)
    return (gset // (num_sets // num_shards)).to(torch.int32)


def route(owner: torch.Tensor, num_shards: int, capacity: int,
          enabled: Optional[torch.Tensor] = None) -> RoutePlan:
    """Stable-sort bucketing along the last dimension.

    ``pos[i]`` is the number of earlier enabled requests owned by the same
    shard: appending to D per-shard queues in arrival order.  Disabled
    lanes sort under the sentinel owner ``num_shards`` (they never displace
    a real request) and are never routed."""
    b = owner.shape[-1]
    dev = owner.device
    if enabled is None:
        enabled = torch.ones(owner.shape, dtype=torch.bool, device=dev)
    enabled = enabled.to(device=dev, dtype=torch.bool)
    big = torch.full(owner.shape, b, dtype=torch.int32, device=dev)
    if num_shards == 1:
        # degenerate routing is the identity: one bucket, arrival order
        pos = torch.cumsum(enabled.to(torch.int32), -1, dtype=torch.int32) - 1
        pos = torch.where(enabled, pos, big)
        return RoutePlan(owner=torch.zeros_like(big), pos=pos,
                         deferred=enabled & (pos >= capacity),
                         enabled=enabled)
    key = torch.where(enabled, owner.to(torch.int32),
                      torch.full_like(big, num_shards))
    sorted_key, perm = torch.sort(key, dim=-1, stable=True)
    idx = torch.arange(b, dtype=torch.int64, device=dev).expand(owner.shape)
    new_group = torch.ones_like(enabled)
    new_group[..., 1:] = sorted_key[..., 1:] != sorted_key[..., :-1]
    group_start = torch.cummax(torch.where(new_group, idx, 0), -1).values
    pos = torch.empty_like(idx).scatter_(-1, perm, idx - group_start)
    pos = torch.where(enabled, pos.to(torch.int32), big)
    return RoutePlan(owner=owner.to(torch.int32), pos=pos,
                     deferred=enabled & (pos >= capacity), enabled=enabled)


def _dest(plan: RoutePlan, capacity: int, num_shards: int) -> torch.Tensor:
    """Flat ``[D*capacity]`` scatter index per lane (int64); un-routed
    lanes point at the sink slot one past the end."""
    return torch.where(plan.routed,
                       plan.owner.long() * capacity + plan.pos.long(),
                       num_shards * capacity)


def _scatter(plan: RoutePlan, values: torch.Tensor, num_shards: int,
             capacity: int, fill) -> torch.Tensor:
    lead = values.shape[:-1]
    n = num_shards * capacity
    flat = torch.full((*lead, n + 1), fill, dtype=values.dtype,
                      device=values.device)
    flat.scatter_(-1, _dest(plan, capacity, num_shards), values)
    return flat[..., :n].reshape(*lead, num_shards, capacity)


def bucket(plan: RoutePlan, values: torch.Tensor, num_shards: int,
           capacity: int, fill) -> torch.Tensor:
    """Scatter a per-request ``[..., B]`` tensor into the ``[..., D,
    capacity]`` bucket layout.  Padding lanes hold ``fill``."""
    return _scatter(plan, values.to(plan.pos.device), num_shards, capacity,
                    fill)


def bucket_mask(plan: RoutePlan, num_shards: int,
                capacity: int) -> torch.Tensor:
    """The ``[..., D, capacity]`` enabled mask: True exactly where a request
    landed."""
    return _scatter(plan, plan.routed, num_shards, capacity, False)


def unscatter(plan: RoutePlan, bucketed: torch.Tensor, fill) -> torch.Tensor:
    """Inverse permutation: per-request results ``[B, ...]`` back in the
    original batch order from the ``[D, capacity, ...]`` bucket layout.
    Deferred and disabled lanes read ``fill``."""
    d, capacity = bucketed.shape[:2]
    flat = bucketed.reshape((d * capacity,) + tuple(bucketed.shape[2:]))
    take = torch.where(plan.routed,
                       plan.owner.long() * capacity + plan.pos.long(), 0)
    out = flat[take]
    mask = plan.routed.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype,
                                                  device=out.device))
