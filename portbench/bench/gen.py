"""The general traffic generator: every mix under ``portbench/traffic/`` is
a file of parameters that these functions read.

* Key streams (the cache cells): a Zipf law over a catalog of keys, ranks
  scrambled by a fixed permutation (the catalog's layout, YCSB's scrambled
  zipfian: ``scramble_seed`` in the mix's file), the requests drawn from
  the run's seed on the device in a few large calls.  The layout decides
  which sets the hot keys share, and so how much work the hottest set
  holds: it is the same for every seed.
* Request streams (the serving cells): prompts made of a shared system
  prompt, one of ``sessions`` shared documents (chosen by a Zipf law) and
  a fresh tail, or fresh tokens alone.  The k-th request's lengths and
  session come from a low-discrepancy sequence with fixed offsets
  (``sizes_seed``), so every seed sends the same sizes in the same order
  and the closed loop batches its admissions alike; the tokens come from
  ``numpy.random.default_rng(seed)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M64 = 2**64 - 1
#: fractional parts of these step the k-th request's three draws
_STEPS = ((math.sqrt(5) - 1) / 2, math.sqrt(2) - 1, math.sqrt(3) - 1)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch generator on ``device`` for ``stream`` of the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) & M64)


def zipf_cdf(n: int, alpha: float, device) -> torch.Tensor:
    """float64 [n] cumulative Zipf probabilities of ranks 1..n."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow(-alpha)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


class KeyStream:
    """Keys of a scrambled Zipf law: ``draw(n)`` -> int32 [n] on the
    device, each a catalog id in [0, catalog)."""

    def __init__(self, spec: dict, seed: int, device):
        self.cdf = zipf_cdf(spec["catalog"], spec["alpha"], device)
        self.perm = torch.randperm(
            spec["catalog"], device=device,
            generator=generator(spec["scramble_seed"], device, 0))
        self.gen = generator(seed, device, 1)

    def draw(self, n: int) -> torch.Tensor:
        u = torch.rand(n, generator=self.gen, dtype=torch.float64,
                       device=self.cdf.device)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=len(self.cdf) - 1)
        return self.perm[rank].to(torch.int32)


class RequestStream:
    """Prompts and output lengths of a serving mix.  ``request(k)`` -> (int32
    prompt, max_new) of the k-th request sent; ``prime()`` -> the requests
    that set-up sends first (one a session)."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec = spec
        self.rng = np.random.default_rng(seed & M64)
        self.lo, self.hi = 2, vocab - 1
        self.system = self._tokens(spec.get("system_tokens", 0))
        self.docs = [self._tokens(spec["doc_tokens"])
                     for _ in range(spec.get("sessions", 0))]
        w = np.arange(1, len(self.docs) + 1, dtype=np.float64) ** -spec.get(
            "session_zipf", 1.0)
        self.session_cdf = np.cumsum(w) / w.sum() if len(w) else w
        self.offsets = np.random.default_rng(spec["sizes_seed"]).random(3)

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(self.lo, self.hi, n, dtype=np.int64)

    def _draw(self, k: int, i: int) -> float:
        return (self.offsets[i] + k * _STEPS[i]) % 1.0

    def _span(self, k: int, i: int, lo_hi) -> int:
        lo, hi = lo_hi
        return lo + min(hi - lo, int(self._draw(k, i) * (hi - lo + 1)))

    def _prompt(self, session, tail: int) -> np.ndarray:
        parts = [self.system]
        if session is not None:
            parts.append(self.docs[session])
        parts.append(self._tokens(tail))
        return np.concatenate(parts).astype(np.int32)

    def request(self, k: int):
        tail = self._span(k, 0, self.spec["tail_tokens"])
        max_new = self._span(k, 1, self.spec["max_new"])
        session = None
        if self.docs:
            session = min(len(self.docs) - 1, int(np.searchsorted(
                self.session_cdf, self._draw(k, 2), side="right")))
        return self._prompt(session, tail), max_new

    def prime(self):
        """One turn of each session, in order, with the set-up's output
        length (none without sessions)."""
        n = self.spec.get("prime_max_new", 1)
        return [(self._prompt(s, self._span(s, 0, self.spec["tail_tokens"])),
                 n) for s in range(len(self.docs))]
