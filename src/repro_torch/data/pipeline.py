"""Deterministic, shard-aware, checkpointable synthetic data pipeline.

Counterpart of ``repro/data/pipeline.py``, copied: numpy only, so a batch
is bit-equal to the reference's for the same (seed, step, shard).  The
tokens are numpy int32 arrays; the trainer moves them to its device.

Production posture without a filesystem dataset: batches are a *stateless
function of (seed, step, shard)* — a counter-mode generator.  This gives,
for free, the three properties a 1000-node pipeline must have:

  * exact restart: the checkpoint stores only the step counter;
  * elastic resharding: when the data-parallel world size changes, shards
    are re-derived from (step, new_world) with no coordination;
  * no stragglers from input skew: every host computes its own shard
    locally in O(batch).

Token streams are Zipf-ish over the vocab with document structure (BOS every
~doc_len tokens), enough to give the LM a learnable non-uniform target
distribution.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    doc_len: int = 512
    zipf_alpha: float = 1.1


@dataclasses.dataclass
class DataState:
    """The ENTIRE pipeline state — one integer.  Checkpoint-trivial."""
    step: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        # Fixed Zipf table (derived from seed only — identical on all hosts).
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._p = p / p.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch(self, state: DataState):
        """(tokens, labels) for this host's shard at ``state.step``."""
        cfg = self.cfg
        per = cfg.global_batch // self.num_shards
        # counter-mode: rng seeded by (seed, step, shard) — stateless.
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, state.step, self.shard])
        )
        flat = rng.choice(cfg.vocab_size, size=per * (cfg.seq_len + 1), p=self._p)
        toks = self._perm[flat].reshape(per, cfg.seq_len + 1).astype(np.int32)
        # document boundaries
        bos_mask = rng.random((per, cfg.seq_len + 1)) < (1.0 / cfg.doc_len)
        toks = np.where(bos_mask, 1, toks)
        return toks[:, :-1], toks[:, 1:]

    def advance(self, state: DataState) -> DataState:
        return DataState(step=state.step + 1)

    def reshard(self, state: DataState, shard: int, num_shards: int):
        """Elastic resize: same stream, new world size (exact, stateless)."""
        return SyntheticPipeline(self.cfg, shard, num_shards), DataState(state.step)
