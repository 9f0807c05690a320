"""With the timed path broken underneath, a run's ``correct`` comes out
false: for each fault a cell can have, at small sizes on the CPU (the
harness's look for a card skipped).  A state returned unchanged; half of
the batch left out; an answer or a token altered where it is produced.
(No cell spans chips, so none can leave out an exchange between them.)"""
import time

import pytest
import torch

import small
from bench import main, registry

BENCH = registry.benchmark()


def run_cell(name, seed=77):
    t0 = time.perf_counter()
    result, _, _ = main.execute(BENCH, name, seed, small.seconds(name),
                                False, torch.device("cpu"),
                                lambda: time.perf_counter() - t0,
                                config=small.config(name),
                                traffic=small.traffic(name))
    return result


def _cuda_backend():
    from repro_torch.core.backend import CudaBackend
    return CudaBackend


# -- the replay cell: CacheBackend.replay --------------------------------

def replay_state_unchanged(mp):
    cls = _cuda_backend()
    orig = cls.replay

    def broken(self, state, chunks, enabled, **kw):
        hits, evs, _, sk = orig(self, state, chunks, enabled, **kw)
        return hits, evs, state, sk
    mp.setattr(cls, "replay", broken)


def replay_half_batch(mp):
    cls = _cuda_backend()
    orig = cls.replay

    def broken(self, state, chunks, enabled, **kw):
        en = enabled.clone()
        en[:, en.shape[1] // 2:] = False
        return orig(self, state, chunks, en, **kw)
    mp.setattr(cls, "replay", broken)


def replay_answer_altered(mp):
    cls = _cuda_backend()
    orig = cls.replay

    def broken(self, *a, **kw):
        hits, evs, st, sk = orig(self, *a, **kw)
        hits = hits.clone()
        hits[-1] += 1
        return hits, evs, st, sk
    mp.setattr(cls, "replay", broken)


# -- the serving cells: the engine's tick --------------------------------

def serve_cache_unchanged(mp):
    """The prefix cache's transaction returns its state unchanged."""
    cls = _cuda_backend()
    orig = cls.access

    def broken(self, state, *a, **kw):
        return (state,) + tuple(orig(self, state, *a, **kw)[1:])
    mp.setattr(cls, "access", broken)


def serve_half_batch(mp):
    """Each decode step computes the first half of the slots only."""
    from repro_torch.serve import paged_model as pm
    orig = pm.decode_paged_sink

    def broken(cfg, model, token, pos, pool_k, pool_v, page_table, active):
        act = active.clone()
        act[act.shape[0] // 2:] = False
        return orig(cfg, model, token, pos, pool_k, pool_v, page_table, act)
    mp.setattr(pm, "decode_paged_sink", broken)


def serve_token_altered(mp):
    from repro_torch.serve import engine
    orig = engine._argmax
    mp.setattr(engine, "_argmax", lambda logits: (orig(logits) + 1)
               % logits.shape[-1])


FAULTS = {
    "replay-ycsbc": [replay_state_unchanged, replay_half_batch,
                     replay_answer_altered],
    "serve-sessions": [serve_cache_unchanged, serve_half_batch,
                       serve_token_altered],
}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_not_correct(name, fault, monkeypatch):
    small.steady_clock(monkeypatch, name)
    fault(monkeypatch)
    result = run_cell(name)
    assert result["correct"] is False, result["checks"]


def test_every_cell_has_faults():
    assert set(FAULTS) == {w["name"] for w in BENCH["workloads"]}
