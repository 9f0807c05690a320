"""The tracer's device readings on the card (``repro_torch.obs``): the
serving tick's events captured inside its CUDA graphs, the graphs captured
without them when tracing is off, and kernel 3's time per lane of its
longest chain.  Each test skips without a card; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs_gpu.py

Imports no JAX.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch import obs

pytestmark = pytest.mark.gpu

TICK = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96, max_prompt=80, backend="cuda", jitted=True,
            decode_block=3)
#: cudaGraphNodeTypeEventRecord (CUDA runtime's cudaGraphNodeType)
EVENT_RECORD_NODE = 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    obs.disable()
    obs.clear()
    try:
        yield torch.device("cuda")
    finally:
        obs.disable()
        obs.clear()


def _model(dev):
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get("deepseek-7b").smoke
    return cfg, lm.init_params(cfg, seed=0, device=dev)


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, 40)
    return [np.concatenate([shared, rng.integers(2, vocab - 1,
                                                 int(rng.integers(3, 14)))])
            for _ in range(n)]


def _engine(dev, trace):
    from repro_torch.serve import engine as teng
    cfg, model = _model(dev)
    (obs.enable if trace else obs.disable)()
    eng = teng.Engine(cfg, model, teng.EngineConfig(**TICK), device=dev)
    for p in _prompts(cfg.vocab_size, 9):
        eng.submit(p, max_new=7)
    return cfg, eng


def _cudart():
    for name in ("libcudart.so", "libcudart.so.12",
                 "/usr/local/cuda/lib64/libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("no CUDA runtime library to count graph nodes with")


def _event_nodes(graph) -> int:
    """The event-record nodes of a captured ``torch.cuda.CUDAGraph``."""
    rt = _cudart()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(t)) == 0
        kinds.append(t.value)
    return kinds.count(EVENT_RECORD_NODE)


def test_tick_events_time_each_phase_within_the_tick(cuda):
    """Every tick's phases in graph order, each a positive device time,
    their sum within the tick's start-to-``_done`` time; the gap since the
    previous tick measured from the second tick on."""
    _, eng = _engine(cuda, True)
    eng.run()
    steps = obs.spans("serve.step")
    assert len(steps) == sum(eng.ticks.values()) > 2
    db = TICK["decode_block"]
    kinds = set()
    for i, s in enumerate(steps):
        a = s.attrs
        kinds.add(a["kind"])
        want = (["prefix", "prefill"] if a["kind"] == "admit" else []) \
            + ["decode"] * db
        assert [p for p, _ in a["phases"]] == want
        ms = [m for _, m in a["phases"]]
        assert all(m > 0 for m in ms), a
        assert sum(ms) <= a["tick_ms"] + 1e-3, a
        assert (a["gap_ms"] is None) == (i == 0)
        if i:
            assert a["gap_ms"] >= 0
    assert kinds == {"admit", "decode"}


def test_tracing_off_captures_the_graphs_without_events(cuda, monkeypatch):
    """Built with tracing off, the graphs hold no event node and the
    launches of the untraced body; with tracing on, one event node a
    phase mark and the same launches; both serve the same tokens."""
    real = torch.cuda.CUDAGraph
    # keep each captured cudaGraph_t, to count its nodes
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: real(keep_graph=True))
    runs = {}
    for trace in (False, True):
        cfg, eng = _engine(cuda, trace)
        nodes = {k: _event_nodes(g) for k, g in eng._graphs.items()}
        fin = eng.run()
        runs[trace] = (nodes, eng.graph_launches, eng.stats,
                       {r: list(q.generated) for r, q in fin.items()}, eng)
    db = TICK["decode_block"]
    assert runs[False][0] == {"admit": 0, "decode": 0}
    assert runs[True][0] == {"admit": 2 + db, "decode": db}
    assert runs[False][1] == runs[True][1] == {
        "admit": {"kway_fused_probe": TICK["max_batch"],
                  "paged_attention": db * cfg.num_layers},
        "decode": {"paged_attention": db * cfg.num_layers}}
    assert runs[False][2:4] == runs[True][2:4]
    assert runs[False][4]._edges is None


def test_k3_chain_ns_is_finite_on_a_zipf_trace(cuda):
    """Kernel 3 on a small zipf trace with tracing on: one ``replay.kernel``
    span a launch, timed on the card, and the counter equal to the largest
    owner bucket of each launch (the plain bucketing's)."""
    from repro_torch.core import hashing, traces
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig, route
    from repro_torch.kernels import replay as krp
    cfg = KWayConfig(num_sets=1024, ways=8)
    be = make_backend("cuda", cfg, cuda)
    steps, batch = 64, 1024
    tr = traces.generate("zipf", steps * batch, seed=3, catalog=2**15)
    chunks = hashing.key_tensor(tr.reshape(steps, batch), cuda)
    en = torch.ones((steps, batch), dtype=torch.bool, device=cuda)
    obs.enable()
    for _ in range(2):
        be.replay(be.init(), chunks, en)
    torch.cuda.synchronize()
    qk, sets = route(cfg, chunks.reshape(-1))
    bk = krp.bucket_lanes_ref(qk.view(steps, batch).cpu(),
                              sets.view(steps, batch).to(torch.int32).cpu(),
                              en.cpu(), cfg.num_sets)
    spans = obs.spans("replay.kernel")
    assert len(spans) == 2 and all(len(s.device_ms) == 1 for s in spans)
    lanes = obs.counters()["replay.chain_lanes"]
    assert lanes == 2 * int(krp.chain_lanes(bk)) > 0
    ns = sum(s.device_ms[0] for s in spans) * 1e6 / lanes
    assert math.isfinite(ns) and ns > 0
