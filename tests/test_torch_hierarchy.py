"""The L1-over-L2 hierarchy of the port against ``repro.core.hierarchy``.

``hierarchy.replay_l1_over_l2`` (the plain version of kernel 4) against
the reference's on the same numpy inputs: 5 policies x promote/demote x
with and without TTLs, per-chunk hits and evictions and both tiers' final
states, with disabled tail lanes.  Also: an L2 of one set (every demotion
lands in the lane's own ``s2`` row), a hierarchy handed over mid-trace
with ``state_from_numpy``, ``l1_sets == 0`` as the flat path, the entry
points (``replay_batched(hierarchy=...)`` on both backends), one tiny case
against the Pallas kernel in interpret mode, and the six committed
``hier-hr/*`` hit ratios (port alone).  Every comparison is exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import hierarchy as jh
from repro.core import router as jrouter
from repro.core import simulate as jsim
from repro.core import traces as jtraces
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro.kernels import ops as jops
from repro_torch.core import hierarchy as th
from repro_torch.core import kway as tkway
from repro_torch.core import simulate, trace_io, traces
from repro_torch.core.backend import make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock", "expiry")
BATCH = 16


def _cfgs(num_sets, ways, policy):
    return (JConfig(num_sets=num_sets, ways=ways, policy=JPolicy(int(policy))),
            KWayConfig(num_sets=num_sets, ways=ways, policy=policy))


def _hcfgs(**kw):
    return jh.HierarchyConfig(**kw), th.HierarchyConfig(**kw)


def _assert_tier(jst, tst, msg):
    got = tkway.state_to_numpy(tst)
    for leaf in LEAVES:
        want = getattr(jst, leaf)
        if want is None:
            assert leaf not in got, f"{msg}: {leaf}"
            continue
        np.testing.assert_array_equal(got[leaf], np.asarray(want),
                                      err_msg=f"{msg}: {leaf}")


def _assert_replays_equal(jout, tout, msg):
    h1, e1, s1, _ = jout
    h2, e2, s2, _ = tout
    np.testing.assert_array_equal(h2.numpy(), np.asarray(h1),
                                  err_msg=f"{msg}: hits")
    np.testing.assert_array_equal(e2.numpy(), np.asarray(e1),
                                  err_msg=f"{msg}: evictions")
    _assert_tier(s1.l1, s2.l1, f"{msg}: L1")
    _assert_tier(s1.l2, s2.l2, f"{msg}: L2")


def _trace(n, seed, ttl, catalog=160):
    """Chunks with a disabled tail (n not a multiple of BATCH) and a few
    disabled lanes inside; TTL chunks or None."""
    if ttl:
        keys, ttls = jtraces.generate_ttl("ttl_churn", n, seed=seed,
                                          catalog=catalog, hot_ttl=150,
                                          churn_ttl=20)
    else:
        keys = jtraces.generate("zipf", n, seed=seed, catalog=catalog)
    chunks, en = jrouter.pad_chunks(keys, BATCH)
    en[min(3, len(en) - 1), 5:9] = False
    tt = jsim._pad_ttl_chunks(ttls, BATCH) if ttl else None
    return chunks, en, tt


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("promote", [True, False])
@pytest.mark.parametrize("demote", [True, False])
@pytest.mark.parametrize("ttl", [False, True], ids=["plain", "ttl"])
def test_replay_l1_over_l2_matches_reference(policy, promote, demote, ttl):
    jcfg, tcfg = _cfgs(16, 4, policy)
    jhc, thc = _hcfgs(l1_sets=4, l1_ways=4, promote=promote, demote=demote)
    chunks, en, tt = _trace(300, int(policy) + 2 * promote + 4 * demote, ttl)
    jout = jh.replay_l1_over_l2(jcfg, jhc, jh.make_hier(jcfg, jhc, ttl=ttl),
                                chunks, en, ttls=tt)
    tout = th.replay_l1_over_l2(
        tcfg, thc, th.make_hier(tcfg, thc, device="cpu", ttl=ttl), chunks,
        en, ttls=tt)
    _assert_replays_equal(jout, tout, f"{policy.name}/{promote}/{demote}")
    assert int(np.asarray(jout[0]).sum()) > 0
    assert ttl or int(np.asarray(jout[1]).sum()) > 0


@pytest.mark.parametrize("ttl", [False, True], ids=["plain", "ttl"])
def test_demotion_into_the_lanes_own_l2_row(ttl):
    """An L2 of one set: every demoted key lands in the row the lane's own
    phase B just wrote (promotion cleared), the aliasing case."""
    jcfg, tcfg = _cfgs(1, 4, Policy.LRU)
    jhc, thc = _hcfgs(l1_sets=2, l1_ways=2)
    chunks, en, tt = _trace(200, 4, ttl, catalog=24)
    jout = jh.replay_l1_over_l2(jcfg, jhc, jh.make_hier(jcfg, jhc, ttl=ttl),
                                chunks, en, ttls=tt)
    tout = th.replay_l1_over_l2(
        tcfg, thc, th.make_hier(tcfg, thc, device="cpu", ttl=ttl), chunks,
        en, ttls=tt)
    _assert_replays_equal(jout, tout, "one-set L2")
    assert int(np.asarray(jout[0]).sum()) > 0


@pytest.mark.parametrize("policy", [Policy.LFU, Policy.HYPERBOLIC])
def test_hierarchy_resumes_a_reference_state(policy):
    """Both tiers of a reference hierarchy, mid-trace, through
    ``state_from_numpy``: the port finishes the trace as the reference
    does, on the plain version and through the ``cuda`` backend."""
    jcfg, tcfg = _cfgs(16, 4, policy)
    jhc, thc = _hcfgs(l1_sets=4, l1_ways=4)
    chunks, en, tt = _trace(320, 8, True)
    _, _, mid, _ = jh.replay_l1_over_l2(
        jcfg, jhc, jh.make_hier(jcfg, jhc, ttl=True), chunks[:8], en[:8],
        ttls=tt[:8])
    jout = jh.replay_l1_over_l2(jcfg, jhc, mid, chunks[8:], en[8:],
                                ttls=tt[8:])

    def tier(st):
        return tkway.state_from_numpy(
            {f: np.asarray(getattr(st, f)) for f in LEAVES}, device="cpu")

    hst = th.HierState(l1=tier(mid.l1), l2=tier(mid.l2))
    _assert_replays_equal(jout, th.replay_l1_over_l2(
        tcfg, thc, hst, chunks[8:], en[8:], ttls=tt[8:]), "plain")
    be = make_backend("cuda", tcfg, device="cpu")
    _assert_replays_equal(jout, be.replay(hst, chunks[8:], en[8:],
                                          hierarchy=thc, ttls=tt[8:]),
                          "cuda backend")


def test_l1_sets_zero_is_the_flat_path():
    tcfg = KWayConfig(num_sets=16, ways=4, policy=Policy.LRU)
    tr = traces.generate("zipf", 500, seed=3, catalog=200)
    for name in ("torch", "cuda"):
        sim = simulate.SimConfig(tcfg, backend=name, device="cpu")
        flat = simulate.replay_batched(sim, tr, batch=BATCH)
        assert simulate.replay_batched(
            sim, tr, batch=BATCH,
            hierarchy=th.HierarchyConfig(l1_sets=0)) == flat
    be = make_backend("torch", tcfg, device="cpu")
    chunks, en = jrouter.pad_chunks(tr, BATCH)
    h1, _, s1, _ = be.replay(be.init(), chunks, en)
    h2, _, s2, _ = be.replay(be.init(), chunks, en,
                             hierarchy=th.HierarchyConfig(l1_sets=0))
    assert torch.equal(h1, h2) and torch.equal(s1.keys, s2.keys)


@pytest.mark.parametrize("ttl", [False, True], ids=["plain", "ttl"])
def test_replay_batched_hierarchy_matches_reference(ttl):
    """The entry point: hit ratios of ``replay_batched(hierarchy=...)`` on
    both backends equal the reference's."""
    jcfg, tcfg = _cfgs(16, 4, Policy.HYPERBOLIC)
    jhc, thc = _hcfgs(l1_sets=4, l1_ways=4)
    if ttl:
        tr, ttls = jtraces.generate_ttl("ttl_churn", 400, seed=6, catalog=160,
                                        hot_ttl=150, churn_ttl=20)
    else:
        tr, ttls = jtraces.generate("recency", 400, seed=6), None
    want = jsim.replay_batched(jsim.SimConfig(jcfg), tr, batch=BATCH,
                               hierarchy=jhc, ttls=ttls)
    for name in ("torch", "cuda"):
        sim = simulate.SimConfig(tcfg, backend=name, device="cpu")
        assert simulate.replay_batched(sim, tr, batch=BATCH, hierarchy=thc,
                                       ttls=ttls) == want, name


def test_hierarchy_matches_pallas_kernel_interpret():
    """One tiny case through the reference's Pallas hierarchy kernel
    (interpret mode on the CPU)."""
    jcfg, tcfg = _cfgs(8, 4, Policy.LRU)
    jhc, thc = _hcfgs(l1_sets=2, l1_ways=4)
    chunks, en, _ = _trace(48, 1, False, catalog=60)
    st = jh.make_hier(jcfg, jhc)
    jout = jops.replay_hierarchical(jcfg, jhc, st, chunks, en)
    be = make_backend("cuda", tcfg, device="cpu")
    tout = be.replay(be.init(), chunks, en, hierarchy=thc)
    _assert_replays_equal(jout, tout, "pallas")


def test_committed_hier_hr_records():
    """The port alone reproduces the six ``hier-hr/*`` hit ratios of
    BENCH_throughput_hierarchy_quick.json (figures.py: L2 64 x 8 LRU,
    ``l1_sets`` in {0, 16, 64} x 16 ways, seed 7, batch 64; zipf over a
    4096-key catalog and the ``lirs_two_pools`` fixture)."""
    path = os.path.join(ROOT, "benchmarks", "baselines",
                        "BENCH_throughput_hierarchy_quick.json")
    with open(path) as f:
        recs = [r for r in json.load(f)["records"]
                if r["id"].startswith("hier-hr/")]
    assert len(recs) == 6
    assert "lirs_two_pools" in trace_io.register_fixture_traces()
    cfg = KWayConfig(num_sets=64, ways=8, policy=Policy.LRU)
    sim = simulate.SimConfig(cfg, backend="cuda", device="cpu")
    for r in recs:
        kw = {"catalog": 4096} if r["family"] == "zipf" else {}
        tr = traces.generate(r["family"], r["n"], seed=7, **kw)
        got = simulate.replay_batched(
            sim, tr, batch=r["batch"],
            hierarchy=th.HierarchyConfig(l1_sets=r["l1_sets"],
                                         l1_ways=r["l1_ways"]))
        assert got == r["value"], (r["id"], got)


def test_hierarchy_config_and_state_helpers():
    with pytest.raises(AssertionError):
        th.HierarchyConfig(l1_sets=3)
    with pytest.raises(AssertionError):
        th.HierarchyConfig(l1_sets=4, l1_ways=129)
    cfg = KWayConfig(num_sets=8, ways=4)
    hc = th.HierarchyConfig(l1_sets=2, l1_ways=3)
    assert th.l1_config(cfg, hc).seed == cfg.seed ^ th.L1_SEED_SALT
    st = th.as_hier_state(cfg, hc, tkway.make_cache(cfg, device="cpu"),
                          ttl=True)
    assert st.l1.keys.shape == (2, 3) and st.l1.expiry is not None
    assert st.l2.expiry is not None and int(st.occupancy()) == 0
    with pytest.raises(ValueError, match="l1_sets > 0"):
        th.replay_l1_over_l2(cfg, th.HierarchyConfig(l1_sets=0), st,
                             np.zeros((1, 2), np.uint32),
                             np.ones((1, 2), bool))


def test_launch_tally_refuses_an_unknown_kind():
    from repro_torch.kernels import replay as krp
    for kind in ("flat", "tinylfu", "hier"):
        assert krp.launches(kind) >= 0
    with pytest.raises(ValueError, match="kind"):
        krp.launches("hierarchy")
