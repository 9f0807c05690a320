"""Serial Python oracle of the k-way cache — ground truth for tests.

Counterpart of ``repro/core/refimpl.py`` on the port's own hashing: a
direct transcription of the paper's Algorithms 1-6, single-threaded.  The
batched paths at batch size 1 must agree with it exactly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import hash_u32_int
from repro_torch.core.policies import Policy


class RefKWay:
    def __init__(self, num_sets: int, ways: int, policy: Policy, seed: int = 0x51CA):
        self.num_sets, self.ways, self.policy, self.seed = num_sets, ways, policy, seed
        # each set: `ways` slots, None == empty; slot-for-slot with the
        # tensor layout so tie-breaking is identical (lowest way wins ties,
        # empty ways fill first).
        self.sets = [[None] * ways for _ in range(num_sets)]
        self.clock = 0

    def _set_of(self, key: int) -> int:
        return hash_u32_int(key, self.seed) & (self.num_sets - 1)

    def _score(self, node, now):
        """Victim score in the float32 domain the tensor paths compare in
        (float64 would resolve float32 score ties differently)."""
        p = self.policy
        if p in (Policy.LRU, Policy.LFU, Policy.FIFO):
            return float(np.float32(node["a"]))
        if p == Policy.RANDOM:
            return float(np.float32(
                hash_u32_int(node["key"] ^ (now & 0xFFFFFFFF), 0xBADA)))
        if p == Policy.HYPERBOLIC:
            age = np.float32(now - node["b"]) + np.float32(1.0)
            return float(np.float32(node["a"]) / age)
        raise ValueError(p)

    def _touch(self, node, now):
        if self.policy == Policy.LRU:
            node["a"] = now
        elif self.policy in (Policy.LFU, Policy.HYPERBOLIC):
            node["a"] += 1

    def get(self, key: int):
        now = self.clock
        self.clock += 1
        for node in self.sets[self._set_of(key)]:
            if node is not None and node["key"] == key:
                self._touch(node, now)
                return node["val"]
        return None

    def put(self, key: int, val: int, admit: bool = True):
        """-> (evicted_key | None, set_idx | None, way | None); the slot is
        None when the key was not admitted."""
        now = self.clock
        self.clock += 1
        si = self._set_of(key)
        s = self.sets[si]
        for i, node in enumerate(s):
            if node is not None and node["key"] == key:
                node["val"] = val
                self._touch(node, now)
                return None, si, i
        if not admit:
            return None, None, None
        evicted = None
        way = next((i for i, node in enumerate(s) if node is None), None)
        if way is None:
            _, way = min((self._score(n, now), i) for i, n in enumerate(s))
            evicted = s[way]["key"]
        a, b = self._insert_meta(now)
        s[way] = {"key": key, "val": val, "a": a, "b": b}
        return evicted, si, way

    def peek_victim(self, key: int):
        """Prospective victim of ``key`` (None when present or the set has a
        free way), without mutating the cache."""
        now = self.clock
        s = self.sets[self._set_of(key)]
        if any(n is not None and n["key"] == key for n in s):
            return None
        if any(n is None for n in s):
            return None
        _, way = min((self._score(n, now), i) for i, n in enumerate(s))
        return s[way]["key"]

    def _insert_meta(self, now):
        p = self.policy
        if p in (Policy.LRU, Policy.FIFO):
            return now, 0
        if p == Policy.LFU:
            return 1, 0
        if p == Policy.RANDOM:
            return 0, 0
        if p == Policy.HYPERBOLIC:
            return 1, now
        raise ValueError(p)

    def access(self, key: int, val: int):
        """get-then-put-on-miss -> hit bool; a hit still advances the clock
        for its disabled put lane."""
        if self.get(key) is None:
            self.put(key, val)
            return False
        self.clock += 1
        return True

    def contents(self):
        return {n["key"] for s in self.sets for n in s if n is not None}

    def occupancy(self):
        return sum(1 for s in self.sets for n in s if n is not None)
