"""The port alone reproduces the pinned golden trace (tests/golden/trace512.json).

The 512-request zipf trace of tests/test_golden_trace.py, generated by the
port's own ``traces`` and replayed at batch size 1 through the port's
``torch``, ``cuda`` (on CPU tensors: the kernels' plain versions) and
``ref`` backends, fused ``access`` and the two-phase composition: the
per-request hit flags, the eviction sequence and the final cache contents
must equal the file.  No JAX is involved.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import traces
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "trace512.json")


def _golden():
    with open(GOLDEN_PATH) as f:
        g = json.load(f)
    assert g["kind"] == "repro.golden.trace"
    return g


def _events(backend, policy, two_phase):
    cfg = _golden()["config"]
    be = make_backend(backend, KWayConfig(num_sets=cfg["num_sets"],
                                          ways=cfg["ways"], policy=policy),
                      device="cpu")
    access = be.access_two_phase if two_phase else be.access
    tr = traces.generate("zipf", cfg["n"], seed=cfg["trace_seed"],
                         catalog=cfg["catalog"])
    tr[::13] = 0
    state = be.init()
    hits, evictions = [], []
    for i, t in enumerate(tr):
        k = np.asarray([t], np.uint32)
        state, hit, _, ek, ev = access(state, k, k.astype(np.int32))
        hits.append("1" if bool(hit[0]) else "0")
        if bool(ev[0]):
            evictions.append([i, int(ek.numpy().view(np.uint32)[0])])
    keys = state.keys.numpy().astype(np.int64)   # EMPTY is already -1
    return {"hits": "".join(hits), "evictions": evictions,
            "final_keys": keys.ravel().tolist()}


@pytest.mark.parametrize("two_phase", [False, True], ids=["fused", "two_phase"])
@pytest.mark.parametrize("policy", [Policy.LRU, Policy.RANDOM],
                         ids=["LRU", "RANDOM"])
@pytest.mark.parametrize("backend", ["torch", "cuda", "ref"])
def test_port_reproduces_golden_trace(backend, policy, two_phase):
    want = _golden()["per_policy"][policy.name]
    got = _events(backend, policy, two_phase)
    if got["hits"] != want["hits"]:
        i = next(i for i, (a, b) in enumerate(zip(got["hits"], want["hits"]))
                 if a != b)
        raise AssertionError(f"hit sequence diverges at request {i}")
    assert got["evictions"] == want["evictions"]
    assert got["final_keys"] == want["final_keys"]
