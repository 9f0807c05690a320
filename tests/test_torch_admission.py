"""TinyLFU admission of the port against ``repro.core.admission``.

``record`` / ``estimate`` / ``admit`` / ``_age`` on the same numpy inputs:
duplicate keys within a chunk, door words shared by several lanes,
counters saturated at 15, words whose top nibble is 8 or more (negative as
int32), enable masks and a sample short enough to age several times.  Then
the TinyLFU replay — ``replay`` (B=1), ``replay_batched`` chunked and
``resident=True`` on the ``torch`` and ``cuda`` backends (plain versions on
the CPU) — against ``repro.core.simulate`` on the five trace families, the
final sketch against ``repro``'s ``CacheBackend.replay``, a sketch handed
over mid-trace, one tiny case against the Pallas kernel in interpret mode,
and the four committed ``resident-eq/*/tinylfu`` hit ratios (port alone).
Every comparison is exact.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as ja
from repro.core import router as jrouter
from repro.core import simulate as jsim
from repro.core import traces as jtraces
from repro.core.backend import make_backend as jmake
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro_torch.core import admission as ta
from repro_torch.core import kway as tkway
from repro_torch.core import simulate, traces
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FAMILIES = ["zipf", "zipf_shift", "scan_loop", "recency", "oltp_mix"]
POLICIES = [Policy.LRU, Policy.LFU, Policy.HYPERBOLIC]
#: a narrow sketch that saturates, shares door words and ages often
NARROW = dict(width=64, door_bits=64, sample=300)


def _cfgs(**kw):
    return ja.TinyLFUConfig(**kw), ta.TinyLFUConfig(**kw)


def _keys(k):
    return torch.from_numpy(np.asarray(k, np.uint32).view(np.int32))


def _assert_sketch(jst, tst, msg):
    got = ta.sketch_to_numpy(tst)
    np.testing.assert_array_equal(got["packed"], np.asarray(jst.packed),
                                  err_msg=f"{msg}: packed")
    np.testing.assert_array_equal(got["door"], np.asarray(jst.door),
                                  err_msg=f"{msg}: door")
    assert int(got["additions"]) == int(jst.additions), f"{msg}: additions"


@pytest.mark.parametrize("sample", [300, 10**6])
def test_record_estimate_match_reference(sample):
    """Sixty chunks of 32 keys from a catalog of 40 (duplicates in every
    chunk, 2 door words for 32 lanes), the sentinel key, 20 % of lanes
    disabled; ``sample=10**6`` never ages, so counters reach 15."""
    jc, tc = _cfgs(width=64, door_bits=64, sample=sample)
    rng = np.random.default_rng(sample)
    js, ts = ja.make_sketch(jc), ta.make_sketch(tc, "cpu")
    aged = 0
    for step in range(60):
        keys = rng.integers(0, 40, 32).astype(np.uint32)
        keys[:2] = 0xFFFFFFFF
        en = rng.random(32) < 0.8
        before = int(js.additions)
        js = ja.record(jc, js, jnp.asarray(keys), enabled=jnp.asarray(en))
        ts = ta.record(tc, ts, _keys(keys), torch.from_numpy(en))
        aged += int(js.additions) < before
        _assert_sketch(js, ts, f"step {step}")
        np.testing.assert_array_equal(
            ta.estimate(tc, ts, _keys(keys)).numpy(),
            np.asarray(ja.estimate(jc, js, jnp.asarray(keys))))
    words = np.asarray(js.packed)
    if sample == 300:
        assert aged >= 4
    else:
        nibbles = (words[..., None] >> (4 * np.arange(8))) & 0xF
        assert (nibbles == 15).any() and (words >= 1 << 31).any()


def test_record_without_mask_and_age_match_reference():
    jc, tc = _cfgs(width=128, door_bits=256, sample=10**6)
    rng = np.random.default_rng(3)
    js, ts = ja.make_sketch(jc), ta.make_sketch(tc, "cpu")
    for _ in range(30):
        keys = rng.integers(0, 100, 64).astype(np.uint32)
        js = ja.record(jc, js, jnp.asarray(keys))
        ts = ta.record(tc, ts, _keys(keys))
    _assert_sketch(js, ts, "record")
    _assert_sketch(ja._age(js), ta._age(ts), "_age")


def test_admit_matches_reference():
    jc, tc = _cfgs(**NARROW)
    rng = np.random.default_rng(11)
    js, ts = ja.make_sketch(jc), ta.make_sketch(tc, "cpu")
    for _ in range(8):
        keys = rng.integers(0, 30, 48).astype(np.uint32)
        js = ja.record(jc, js, jnp.asarray(keys))
        ts = ta.record(tc, ts, _keys(keys))
    cand = rng.integers(0, 30, 200).astype(np.uint32)
    vict = rng.integers(0, 30, 200).astype(np.uint32)
    vict[:10] = 0xFFFFFFFF
    valid = rng.random(200) < 0.7
    want = np.asarray(ja.admit(jc, js, jnp.asarray(cand), jnp.asarray(vict),
                               jnp.asarray(valid)))
    got = ta.admit(tc, ts, _keys(cand), _keys(vict), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 200


def test_sketch_numpy_round_trip():
    jc, tc = _cfgs(**NARROW)
    js = ja.record(jc, ja.make_sketch(jc),
                   jnp.asarray(np.arange(50, dtype=np.uint32) % 7))
    arrays = {f: np.asarray(getattr(js, f))
              for f in ("packed", "door", "additions")}
    ts = ta.sketch_from_numpy(arrays, device="cpu")
    _assert_sketch(js, ts, "round trip")
    assert ts.packed.dtype == torch.int32 and ts.door.dtype == torch.int32


_JBACKENDS: dict = {}


def _jbackend(policy):
    """One reference backend per policy, so its jitted replay compiles
    once."""
    if policy not in _JBACKENDS:
        _JBACKENDS[policy] = jmake("jnp", JConfig(num_sets=16, ways=4,
                                                  policy=JPolicy(int(policy))))
    return _JBACKENDS[policy]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_tinylfu_replay_matches_reference(family, policy):
    """Hit ratios of ``replay`` (B=1) and ``replay_batched`` chunked and
    resident on both backends; per-chunk counts, final state and final
    sketch of ``CacheBackend.replay``."""
    jc, tc = _cfgs(**NARROW)
    jcfg = JConfig(num_sets=16, ways=4, policy=JPolicy(int(policy)))
    tcfg = KWayConfig(num_sets=16, ways=4, policy=policy)
    tr = jtraces.generate(family, 500, seed=int(policy) + 3)
    want_b1 = jsim.replay(jsim.SimConfig(jcfg, tinylfu=jc), tr[:200])
    want = jsim.replay_batched(jsim.SimConfig(jcfg, tinylfu=jc), tr, batch=32)
    for name in ("torch", "cuda"):
        sim = simulate.SimConfig(tcfg, tinylfu=tc, backend=name, device="cpu")
        assert simulate.replay(sim, tr[:200]) == want_b1, name
        for resident in (False, True):
            assert simulate.replay_batched(sim, tr, batch=32,
                                           resident=resident) == want, name

    chunks, en = jrouter.pad_chunks(tr, 32)
    h1, e1, s1, k1 = _jbackend(policy).replay(
        _jbackend(policy).init(), chunks, en, tinylfu=jc)
    for name in ("torch", "cuda"):
        tb = make_backend(name, tcfg, device="cpu")
        h2, e2, s2, k2 = tb.replay(tb.init(), chunks, en, tinylfu=tc)
        np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
        np.testing.assert_array_equal(e2.numpy(), np.asarray(e1))
        got = tkway.state_to_numpy(s2)
        for leaf in ("keys", "fprint", "vals", "meta_a", "meta_b", "clock"):
            np.testing.assert_array_equal(got[leaf],
                                          np.asarray(getattr(s1, leaf)),
                                          err_msg=f"{name}: {leaf}")
        _assert_sketch(k1, k2, name)


def test_tinylfu_replay_resumes_a_reference_sketch():
    """A reference state and sketch handed to the port mid-trace: the port
    finishes the trace as the reference does."""
    jc, tc = _cfgs(**NARROW)
    jb = _jbackend(Policy.LFU)
    tr = jtraces.generate("zipf", 640, seed=5, catalog=200)
    chunks, en = jrouter.pad_chunks(tr, 32)
    _, _, s_mid, k_mid = jb.replay(jb.init(), chunks[:10], en[:10],
                                   tinylfu=jc)
    h1, _, s1, k1 = jb.replay(s_mid, chunks[10:], en[10:], tinylfu=jc,
                              sketch=k_mid)
    st = tkway.state_from_numpy(
        {f: np.asarray(getattr(s_mid, f)) for f in
         ("keys", "fprint", "vals", "meta_a", "meta_b", "clock")},
        device="cpu")
    sk = ta.sketch_from_numpy(
        {f: np.asarray(getattr(k_mid, f))
         for f in ("packed", "door", "additions")}, device="cpu")
    for name in ("torch", "cuda"):
        tb = make_backend(name, KWayConfig(num_sets=16, ways=4,
                                           policy=Policy.LFU), device="cpu")
        h2, _, s2, k2 = tb.replay(st, chunks[10:], en[10:], tinylfu=tc,
                                  sketch=sk)
        np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
        np.testing.assert_array_equal(tkway.state_to_numpy(s2)["keys"],
                                      np.asarray(s1.keys))
        _assert_sketch(k1, k2, name)


def test_tinylfu_matches_pallas_kernel_interpret():
    """One tiny case through the Pallas kernel (interpret mode on the CPU,
    as tests/test_resident.py runs it)."""
    jc, tc = _cfgs(width=64, door_bits=64, sample=40)
    jcfg = JConfig(num_sets=4, ways=4, policy=JPolicy.LRU)
    tr = jtraces.generate("zipf", 64, seed=2, catalog=40)
    chunks, en = jrouter.pad_chunks(tr, 16)
    pb = jmake("pallas", jcfg)
    h1, e1, s1, k1 = pb.replay(pb.init(), chunks, en, tinylfu=jc)
    tb = make_backend("cuda", KWayConfig(num_sets=4, ways=4), device="cpu")
    h2, e2, s2, k2 = tb.replay(tb.init(), chunks, en, tinylfu=tc)
    np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
    np.testing.assert_array_equal(e2.numpy(), np.asarray(e1))
    np.testing.assert_array_equal(tkway.state_to_numpy(s2)["meta_a"],
                                  np.asarray(s1.meta_a))
    _assert_sketch(k1, k2, "pallas")


def test_committed_resident_eq_tinylfu_records():
    """The port alone reproduces the four ``resident-eq/*/tinylfu`` hit
    ratios of BENCH_throughput_resident_quick.json (figures.py: 128 x 8,
    ``for_capacity(1024)``, seed 42, batch 256), resident and chunked."""
    path = os.path.join(ROOT, "benchmarks", "baselines",
                        "BENCH_throughput_resident_quick.json")
    with open(path) as f:
        recs = [r for r in json.load(f)["records"]
                if r["id"].startswith("resident-eq/")
                and r["admission"] == "tinylfu"]
    assert len(recs) == 4
    tl = ta.for_capacity(1024)
    for r in recs:
        cfg = KWayConfig(num_sets=128, ways=8,
                         policy=Policy.parse(r["policy"]))
        tr = traces.generate(r["family"], r["n"], seed=42)
        sim = simulate.SimConfig(cfg, tinylfu=tl, backend="cuda",
                                 device="cpu")
        for resident in (True, False):
            got = simulate.replay_batched(sim, tr, batch=r["batch"],
                                          resident=resident)
            assert got == r["value"], (r["id"], resident, got)
