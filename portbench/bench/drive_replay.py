"""Driver of the trace-replay mixes: whole traces through
``CacheBackend.replay`` (on the ``cuda`` backend, kernel 3), each replay
from a fresh cache, its per-chunk hits and evictions read to the host.

Traffic parameters: ``keys`` (the key law, ``gen.KeyStream``), ``traces``
(how many distinct traces the set-up draws), ``requests`` (a trace's
length) and ``batch`` (requests a chunk).  The window replays the traces in
turn; every replay's hits and evictions, and each trace's last final
state, are held to the plain reference afterwards.
"""
from __future__ import annotations

import collections
import time

import torch

from bench import gen, limits
from bench.cache import build_backend, state_mismatch
from bench.trace import Tracer
from reference import kway as kref


def draw_traces(t: dict, seed: int, device) -> torch.Tensor:
    """The mix's traces from ``seed``: int32 [traces, requests // batch,
    batch] on ``device``, drawn a trace at a time."""
    n, b = t["requests"], t["batch"]
    if n % b:
        raise ValueError("a trace's length must be a multiple of batch")
    keys = gen.KeyStream(t["keys"], seed, device)
    out = torch.empty((t["traces"], n // b, b), dtype=torch.int32,
                      device=device)
    for i in range(t["traces"]):
        out[i] = keys.draw(n).view(n // b, b)
    return out


class Cell:
    def __init__(self, run):
        self.run = run
        self.attempted = 0
        self.failed = 0

    def setup(self):
        run, t = self.run, self.run.traffic
        self.kcfg, self.be = build_backend(run.config, run.device)
        self.chunks = draw_traces(t, run.seed, run.device)
        self.enabled = torch.ones(self.chunks.shape[1:], dtype=torch.bool,
                                  device=run.device)
        for i in range(t["traces"]):          # every shape the window uses
            self._replay(i, Tracer(False))
        run.sync()

    def _replay(self, i, tr):
        with tr.span("init"):
            st = self.be.init()
        with tr.span("replay"):
            hits, evs, st, _ = self.be.replay(st, self.chunks[i],
                                              self.enabled)
        with tr.span("fetch"):
            out = torch.stack([hits, evs]).cpu()
        return out, st

    def window(self, tr):
        run, t = self.run, self.run.traffic
        self.seen = [collections.Counter() for _ in range(t["traces"])]
        self.last = [None] * t["traces"]
        n = 0
        t0 = time.perf_counter()
        while True:
            i = n % t["traces"]
            out, self.last[i] = self._replay(i, tr)
            self.seen[i][out.numpy().tobytes()] += 1
            n += 1
            t1 = time.perf_counter()
            if t1 - t0 >= run.seconds:
                break
        run.window_s = t1 - t0
        self.attempted = n * t["requests"]
        run.records.update(replays=n, requests=t["requests"],
                           steps=self.chunks.shape[1],
                           capacity=self.kcfg.capacity)

    def release(self):
        self.be = None

    def end_to_end(self) -> dict:
        return {"cache_mreq_s": self.attempted / self.run.window_s / 1e6}

    def check(self) -> list:
        run, cfg = self.run, self.run.config
        ref = kref.empty(len(self.seen), cfg["num_sets"], cfg["ways"],
                         run.device)
        hits, evs = kref.replay(ref, self.chunks)
        wrong = 0
        for i, seen in enumerate(self.seen):
            want = torch.stack([hits[i], evs[i]]).cpu().numpy().tobytes()
            wrong += sum(c for got, c in seen.items() if got != want)
        words = sum(state_mismatch(st, ref, i)
                    for i, st in enumerate(self.last) if st is not None)
        return limits.checks(run.workload["name"], {
            "replays_wrong": wrong, "state_words_wrong": words})

