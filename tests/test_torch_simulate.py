"""The slice end to end: the port's trace replay against repro.core.simulate.

``replay_batched`` (flat, ``resident=True`` and with ``ttls``) and the B=1
``replay`` of ``repro_torch`` against the reference on all five trace
families plus ``ttl_churn``: hit ratios as equal floats, and through
``CacheBackend.replay`` the per-chunk hits and evictions and the final
state.  Also a reference state handed to the port mid-trace.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core import simulate as jsim
from repro.core import traces as jtraces
from repro.core.backend import make_backend as jmake
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro_torch.core import kway as tkway
from repro_torch.core import router, simulate, traces
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

FAMILIES = ["zipf", "zipf_shift", "scan_loop", "recency", "oltp_mix"]
LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock", "expiry")


def _cfgs(num_sets, ways, policy):
    return (JConfig(num_sets=num_sets, ways=ways, policy=JPolicy(int(policy))),
            KWayConfig(num_sets=num_sets, ways=ways, policy=policy))


def _assert_state(jst, tst, msg):
    got = tkway.state_to_numpy(tst)
    for leaf in LEAVES:
        want = getattr(jst, leaf)
        if want is None:
            assert leaf not in got, f"{msg}: {leaf}"
            continue
        np.testing.assert_array_equal(got[leaf], np.asarray(want),
                                      err_msg=f"{msg}: {leaf}")


def test_traces_match_reference():
    for fam in FAMILIES + ["ttl_churn"]:
        np.testing.assert_array_equal(traces.generate(fam, 3000, seed=7),
                                      jtraces.generate(fam, 3000, seed=7))
    k1, t1 = traces.generate_ttl("ttl_churn", 2000, seed=3)
    k2, t2 = jtraces.generate_ttl("ttl_churn", 2000, seed=3)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(router.pad_chunks(k1, 48)[0],
                                  jrouter.pad_chunks(k2, 48)[0])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", [Policy.LRU, Policy.HYPERBOLIC,
                                    Policy.RANDOM])
def test_replay_chunks_match_reference(family, policy):
    """Per-chunk hits and evictions and the final state, through
    ``CacheBackend.replay`` on torch and cuda (plain versions on CPU)."""
    jcfg, tcfg = _cfgs(16, 4, policy)
    tr = jtraces.generate(family, 800, seed=int(policy) + 1)
    chunks, en = jrouter.pad_chunks(tr, 48)
    jb = jmake("jnp", jcfg)
    h1, e1, s1, _ = jb.replay(jb.init(), chunks, en)
    for name in ("torch", "cuda"):
        tb = make_backend(name, tcfg, device="cpu")
        h2, e2, s2, _ = tb.replay(tb.init(), chunks, en)
        np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
        np.testing.assert_array_equal(e2.numpy(), np.asarray(e1))
        _assert_state(s1, s2, f"{family}/{name}")


@pytest.mark.parametrize("policy", list(Policy))
def test_replay_ttl_chunks_match_reference(policy):
    jcfg, tcfg = _cfgs(16, 4, policy)
    keys, ttls = jtraces.generate_ttl("ttl_churn", 900, seed=int(policy),
                                      catalog=256, hot_ttl=600, churn_ttl=30)
    chunks, en = jrouter.pad_chunks(keys, 40)
    tt = jsim._pad_ttl_chunks(ttls, 40)
    jb = jmake("jnp", jcfg)
    h1, e1, s1, _ = jb.replay(jb.init(ttl=True), chunks, en, ttls=tt)
    for name in ("torch", "cuda"):
        tb = make_backend(name, tcfg, device="cpu")
        h2, e2, s2, _ = tb.replay(tb.init(ttl=True), chunks, en, ttls=tt)
        np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
        np.testing.assert_array_equal(e2.numpy(), np.asarray(e1))
        _assert_state(s1, s2, f"ttl/{name}")
    assert int(np.asarray(s1.expiry != 0x7FFFFFFF).sum()) > 0


@pytest.mark.parametrize("family", FAMILIES + ["ttl_churn"])
def test_replay_batched_hit_ratios_match(family):
    """Hit ratios of every replay form, as equal floats."""
    policy = Policy(FAMILIES.index(family) % 5 if family in FAMILIES else 0)
    jcfg, tcfg = _cfgs(32, 4, policy)
    if family == "ttl_churn":
        tr, ttls = jtraces.generate_ttl(family, 700, seed=5, catalog=300)
    else:
        tr, ttls = jtraces.generate(family, 700, seed=5), None
    for backend in ("torch", "cuda"):
        for resident in (False, True):
            want = jsim.replay_batched(jsim.SimConfig(jcfg), tr, batch=32,
                                       resident=resident, ttls=ttls)
            got = simulate.replay_batched(
                simulate.SimConfig(tcfg, backend=backend, device="cpu"), tr,
                batch=32, resident=resident, ttls=ttls)
            assert got == want, (backend, resident)
    want = jsim.replay_batched(jsim.SimConfig(jcfg, backend="ref"), tr,
                               batch=32, ttls=ttls)
    got = simulate.replay_batched(
        simulate.SimConfig(tcfg, backend="ref", device="cpu"), tr, batch=32,
        ttls=ttls)
    assert got == want
    if ttls is None:
        want = jsim.replay_batched(jsim.SimConfig(jcfg, two_phase=True), tr,
                                   batch=32)
        got = simulate.replay_batched(
            simulate.SimConfig(tcfg, backend="torch", two_phase=True,
                               device="cpu"), tr, batch=32)
        assert got == want


@pytest.mark.parametrize("backend", ["torch", "cuda", "ref"])
def test_sequential_replay_matches(backend):
    jcfg, tcfg = _cfgs(8, 4, Policy.HYPERBOLIC)
    tr = jtraces.generate("zipf", 300, seed=9, catalog=90)
    want = jsim.replay(jsim.SimConfig(jcfg), tr)
    got = simulate.replay(simulate.SimConfig(tcfg, backend=backend,
                                             device="cpu"), tr)
    assert got == want


@pytest.mark.parametrize("policy", [Policy.LFU, Policy.RANDOM])
@pytest.mark.parametrize("ttl", [False, True])
def test_state_carry_over_mid_trace(policy, ttl):
    """A reference state taken mid-trace continues on the port exactly as
    the reference continues it."""
    jcfg, tcfg = _cfgs(16, 4, policy)
    if ttl:
        tr, ttls = jtraces.generate_ttl("ttl_churn", 960, seed=1, catalog=200)
        tt = jsim._pad_ttl_chunks(ttls, 32)
    else:
        tr, tt = jtraces.generate("oltp_mix", 960, seed=1), None
    chunks, en = jrouter.pad_chunks(tr, 32)
    half = chunks.shape[0] // 2
    jb = jmake("jnp", jcfg)

    def part(sl):
        return (chunks[sl], en[sl]) + ((tt[sl],) if ttl else ())

    def jrun(st, sl):
        c, e, *t = part(sl)
        return jb.replay(st, c, e, ttls=t[0] if t else None)

    _, _, mid, _ = jrun(jb.init(ttl=ttl), slice(0, half))
    h1, e1, s1, _ = jrun(mid, slice(half, None))
    arrays = {f: np.asarray(getattr(mid, f)) for f in LEAVES
              if getattr(mid, f) is not None}
    for name in ("torch", "cuda"):
        tb = make_backend(name, tcfg, device="cpu")
        c, e, *t = part(slice(half, None))
        h2, e2, s2, _ = tb.replay(tkway.state_from_numpy(arrays, device="cpu"),
                                  c, e, ttls=t[0] if t else None)
        np.testing.assert_array_equal(h2.numpy(), np.asarray(h1))
        np.testing.assert_array_equal(e2.numpy(), np.asarray(e1))
        _assert_state(s1, s2, name)
    assert np.asarray(h1).sum() > 0 and jnp.asarray(mid.clock) > 0
