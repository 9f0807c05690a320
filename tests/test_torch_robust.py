"""The port's robustness layer (``repro_torch.robust``, ``ckpt``) against
``repro.robust`` and ``repro.ckpt``: the counterparts of
``tests/test_robust.py``.

* ``faults``: the same call on the same state (a reference state carried
  over with ``state_from_numpy``) injects the same fault: equal
  ``FaultReport``s and equal states;
* ``invariants``: the same bitmaps (lane, global, sketch, hierarchy) and
  the same ``explain_*`` lines on clean and faulted states;
* ``recovery``: ``scrub`` / ``scrub_hier`` give the reference's state,
  forced tally and bitmap; ``validated_replay`` its hits, evictions, state
  and alarm word, on the ``torch`` and ``cuda`` backends;
* ``ladder``: the rungs and events under healthy runs, a shared-memory
  breach, a failing kernel, validator alarms, TTL ``stale_served``
  descents and unsupported configurations, with the hits of the flat
  replay; and the card's rule (a kernel's exception raised, no
  ``torch-scan`` but for a refused configuration);
* ``ckpt/manager``: the atomic round trip (bf16 bit for bit, ``.tmp``
  ignored, ``keep_last``, mismatches named);
* the serving tick (CPU, eager): ``check_serve`` on the port's
  ``ServeState`` gives the reference's bitmaps on the reference jitted
  engine's state after the same ticks, clean and under the same faults;
  a crash mid-tick restored from the last committed checkpoint re-emits
  the uninterrupted run's tokens.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import admission as jadm
from repro.core import hierarchy as jh
from repro.core import traces as jtraces
from repro.core.backend import make_backend as jmake
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro.core.router import pad_chunks
from repro.core.simulate import _pad_ttl_chunks
from repro.models import lm as jlm
from repro.robust import faults as jfaults
from repro.robust import invariants as jinv
from repro.robust import recovery as jrec
from repro.serve import engine as jeng
from repro_torch import configs
from repro_torch.ckpt import manager
from repro_torch.core import admission
from repro_torch.core import hierarchy as th
from repro_torch.core import kway as tkway
from repro_torch.core.backend import make_backend, smem_budget
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.robust import (CheckpointedEngine, check_cache, check_hier,
                                check_serve, events, explain_cache,
                                explain_hier, explain_serve, faults,
                                resilient_replay, restore_engine,
                                save_engine, scrub, scrub_hier,
                                validated_replay)
from repro_torch.robust.invariants import sketch_bits
from repro_torch.robust.ladder import RUNGS
from repro_torch.serve import engine as teng

torch.set_num_threads(1)

CONFIG = dict(num_sets=16, ways=4)
SEED = 2026
LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock", "expiry")


def golden_trace():
    tr = jtraces.generate("zipf", 512, seed=SEED, catalog=96)
    tr[::13] = 0
    return tr


def _chunks(batch=8):
    return pad_chunks(golden_trace(), batch)


def _ttl_chunks(batch=8):
    rng = np.random.default_rng(SEED + 1)
    chunks, enabled = _chunks(batch)
    return chunks, enabled, _pad_ttl_chunks(
        rng.integers(0, 200, 512).astype(np.int32), batch)


def _cfgs(policy=Policy.LRU, **kw):
    kw = dict(CONFIG, **kw)
    return JConfig(policy=JPolicy(int(policy)), **kw), KWayConfig(
        policy=policy, **kw)


def _leaves(st):
    return {f: np.asarray(getattr(st, f)) for f in LEAVES
            if getattr(st, f) is not None}


def _port(jst):
    return tkway.state_from_numpy(_leaves(jst), device="cpu")


def _bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.astype(np.int64) & 0xFFFFFFFF


def _assert_state(jst, tst, msg=""):
    got = tkway.state_to_numpy(tst)
    assert set(got) == set(_leaves(jst)), msg
    for leaf, want in _leaves(jst).items():
        np.testing.assert_array_equal(_bits(got[leaf]), _bits(want),
                                      err_msg=f"{msg}: {leaf}")


def _same_report(trep, jrep):
    a, b = dataclasses.astuple(trep), dataclasses.astuple(jrep)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float) and math.isnan(x):
            assert math.isnan(y)
        else:
            assert x == y, (trep, jrep)


def _same_cache_report(trep, jrep):
    np.testing.assert_array_equal(_bits(trep.lane_bits),
                                  _bits(jrep.lane_bits))
    assert int(trep.global_bits) == int(jrep.global_bits)
    assert int(trep.bits) == int(jrep.bits)
    assert trep.clean() == jrep.clean()
    assert explain_cache(trep) == jinv.explain_cache(jrep)


def _replayed(policy=Policy.LRU, ttl=False, tinylfu=None):
    """A reference state after the golden trace (jnp backend) and the same
    state in the port."""
    jcfg, tcfg = _cfgs(policy)
    be = jmake("jnp", jcfg)
    if ttl:
        chunks, enabled, tt = _ttl_chunks()
        _, _, jst, _ = be.replay(be.init(ttl=True), chunks, enabled,
                                 ttls=jnp.asarray(tt))
    else:
        chunks, enabled = _chunks()
        _, _, jst, _ = be.replay(be.init(), chunks, enabled, tinylfu=tinylfu)
    return jcfg, tcfg, jst, _port(jst)


# ---------------------------------------------------------------------------
# invariants, faults and scrub against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("ttl", [False, True])
def test_clean_state_bitmaps_match_reference(policy, ttl):
    """A healthy replayed state: every vals / expiry mode gives the
    reference's bitmap (clean for the replay's own convention)."""
    jcfg, tcfg, jst, tst = _replayed(policy, ttl)
    for vals_mode in ("any", "key", "slot"):
        for mode in ("strict", "lazy"):
            _same_cache_report(
                check_cache(tcfg, tst, vals_mode=vals_mode, expiry_mode=mode),
                jinv.check_cache(jcfg, jst, vals_mode=vals_mode,
                                 expiry_mode=mode))
    assert check_cache(tcfg, tst, vals_mode="key").clean()


@pytest.mark.parametrize("site", faults.LANE_SITES)
@pytest.mark.parametrize("step", [0, 3])
def test_flip_bit_detect_scrub_match_reference(site, step):
    """Same injection (report and state), same bitmaps and explain lines,
    same scrub (state, forced evictions, pre-repair bitmap)."""
    jcfg, tcfg, jst, tst = _replayed()
    jst2, jrep = jfaults.flip_bit(jst, site, seed=7, step=step)
    tst2, trep = faults.flip_bit(tst, site, seed=7, step=step)
    _same_report(trep, jrep)
    _assert_state(jst2, tst2, "flipped")
    _assert_state(jst, tst, "input left as it was")
    trep_c = check_cache(tcfg, tst2, vals_mode="key")
    assert not trep_c.clean()
    _same_cache_report(trep_c, jinv.check_cache(jcfg, jst2, vals_mode="key"))
    jst3, jforced, jbits = jrec.scrub(jcfg, jst2, vals_mode="key")
    tst3, tforced, tbits = scrub(tcfg, tst2, vals_mode="key")
    assert int(tforced) == int(jforced) > 0
    np.testing.assert_array_equal(_bits(tbits), _bits(jbits))
    _assert_state(jst3, tst3, "scrubbed")
    assert check_cache(tcfg, tst3, vals_mode="key").clean()


@pytest.mark.parametrize("kind", ["clock_skew", "stale_entry"])
def test_ttl_faults_match_reference(kind):
    """The expiry faults on a TTL state: the same lane, the same
    ``expired_resident`` / ``expired_hit`` bits, the same lane-local or
    clock-wide scrub."""
    jcfg, tcfg, jst, tst = _replayed(ttl=True)
    jst2, jrep = getattr(jfaults, kind)(jst, seed=3, step=7)
    tst2, trep = getattr(faults, kind)(tst, seed=3, step=7)
    _same_report(trep, jrep)
    _assert_state(jst2, tst2, kind)
    rep = check_cache(tcfg, tst2, vals_mode="key")
    _same_cache_report(rep, jinv.check_cache(jcfg, jst2, vals_mode="key"))
    name = "expired_resident" if kind == "clock_skew" else "expired_hit"
    assert any(name in line for line in explain_cache(rep))
    jst3, jforced, _ = jrec.scrub(jcfg, jst2, vals_mode="key")
    tst3, tforced, _ = scrub(tcfg, tst2, vals_mode="key")
    assert int(tforced) == int(jforced) > 0
    _assert_state(jst3, tst3, "scrubbed")


def test_double_resident_matches_reference():
    """Tier exclusivity: the same duplicated entry, the same
    ``double_resident`` lane, the same two-tier scrub (the L1 copy goes,
    the L2 keeps it)."""
    jcfg, tcfg = _cfgs()
    jhc = jh.HierarchyConfig(l1_sets=4, l1_ways=4)
    thc = th.HierarchyConfig(l1_sets=4, l1_ways=4)
    chunks, enabled = _chunks()
    _, _, jst, _ = jh.replay_l1_over_l2(jcfg, jhc, jh.make_hier(jcfg, jhc),
                                        chunks, enabled)
    tst = th.hier_from_numpy({"l1": _leaves(jst.l1), "l2": _leaves(jst.l2)},
                             device="cpu")
    rep = check_hier(tcfg, thc, tst, vals_mode="key")
    assert rep.clean()
    jst2, jrep = jfaults.double_resident(jcfg, jst, seed=11)
    tst2, trep = faults.double_resident(tcfg, tst, seed=11)
    _same_report(trep, jrep)
    _assert_state(jst2.l2, tst2.l2, "l2")
    trep_h = check_hier(tcfg, thc, tst2, vals_mode="key")
    jrep_h = jinv.check_hier(jcfg, jhc, jst2, vals_mode="key")
    assert int(trep_h.bits) == int(jrep_h.bits) != 0
    np.testing.assert_array_equal(_bits(trep_h.double_bits),
                                  _bits(jrep_h.double_bits))
    assert explain_hier(trep_h) == jinv.explain_hier(jrep_h)
    jst3, jf, _ = jrec.scrub_hier(jcfg, jhc, jst2, vals_mode="key")
    tst3, tf, _ = scrub_hier(tcfg, thc, tst2, vals_mode="key")
    assert int(tf) == int(jf) >= 1
    _assert_state(jst3.l1, tst3.l1, "l1")
    _assert_state(jst3.l2, tst3.l2, "l2")
    assert check_hier(tcfg, thc, tst3, vals_mode="key").clean()


def test_unpack_tier_reads_the_reference_row_layout():
    jcfg, tcfg = _cfgs()
    jhc = jh.HierarchyConfig(l1_sets=4, l1_ways=4)
    chunks, enabled = _chunks()
    _, _, jst, _ = jh.replay_l1_over_l2(jcfg, jhc, jh.make_hier(jcfg, jhc),
                                        chunks, enabled)
    packed = np.array(jh._pack_lanes(
        *(jnp.asarray(getattr(jst.l2, f)).astype(jnp.int32)
          for f in ("keys", "fprint", "vals", "meta_a", "meta_b"))))
    from repro_torch.robust.invariants import unpack_tier
    from repro.robust.invariants import unpack_tier as junpack
    want = junpack(jnp.asarray(packed), 4, jst.l2.clock)
    got = unpack_tier(torch.from_numpy(packed), 4, int(jst.l2.clock))
    _assert_state(want, got, "unpacked")


def test_sketch_bits_match_reference():
    jcfg, tcfg = _cfgs()
    jtl = jadm.for_capacity(jcfg.capacity)
    tl = admission.for_capacity(tcfg.capacity)
    chunks, enabled = _chunks()
    be = jmake("jnp", jcfg)
    _, _, _, jsk = be.replay(be.init(), chunks, enabled, tinylfu=jtl)
    cases = [jsk, dataclasses.replace(jsk, additions=jnp.asarray(
        jtl.sample, jnp.int32)), dataclasses.replace(
        jsk, door=jnp.ones_like(jsk.door) * jnp.uint32(0xFF)),
        dataclasses.replace(jsk, additions=jnp.asarray(-1, jnp.int32))]
    for c in cases:
        tsk = admission.sketch_from_numpy(
            {f: np.asarray(getattr(c, f))
             for f in ("packed", "door", "additions")}, device="cpu")
        assert int(sketch_bits(tl, tsk)) == int(jinv.sketch_bits(jtl, c))
    assert int(sketch_bits(tl, admission.sketch_from_numpy(
        {f: np.asarray(getattr(cases[2], f))
         for f in ("packed", "door", "additions")}, device="cpu"))) & 2


def test_empty_lane_dirty_detected():
    _, tcfg = _cfgs()
    st = tkway.make_cache(tcfg, device="cpu")
    st = dataclasses.replace(st, meta_a=st.meta_a.clone())
    st.meta_a[3, 2] = 99
    rep = check_cache(tcfg, st)
    assert not rep.clean()
    assert "set 3 way 2: empty_lane_dirty" in explain_cache(rep)


@pytest.mark.parametrize("kind", ["dup", "poison"])
def test_trace_faults_match_reference_and_are_survived(kind):
    tr, rep = faults.corrupt_trace(golden_trace(), kind, seed=3)
    jtr, jrep = jfaults.corrupt_trace(golden_trace(), kind, seed=3)
    np.testing.assert_array_equal(tr, jtr)
    _same_report(rep, jrep)
    _, tcfg = _cfgs()
    be = make_backend("cuda", tcfg, device="cpu")
    chunks, enabled = pad_chunks(tr, 8)
    _, _, st, _ = be.replay(be.init(), chunks, enabled)
    assert check_cache(tcfg, st, vals_mode="key").clean()
    assert not (st.keys == -1).logical_and(st.vals != 0).any()


# ---------------------------------------------------------------------------
# validated replay
# ---------------------------------------------------------------------------

VALIDATED = {
    "lru-interval4": dict(interval=4),
    "hyperbolic-interval1": dict(interval=1, policy=Policy.HYPERBOLIC),
    "tinylfu": dict(interval=8, tinylfu=True),
    "ttl": dict(interval=4, ttl=True),
    "corrupt-start": dict(interval=1, corrupt=True),
}


@pytest.mark.parametrize("name", sorted(VALIDATED))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_validated_replay_matches_reference(name, backend):
    kw = dict(VALIDATED[name])
    policy = kw.pop("policy", Policy.LRU)
    jcfg, tcfg = _cfgs(policy)
    jkw, tkw = dict(interval=kw["interval"]), dict(interval=kw["interval"])
    if kw.get("ttl"):
        chunks, enabled, tt = _ttl_chunks()
        jkw["ttls"], tkw["ttls"] = tt, tt
    else:
        chunks, enabled = _chunks()
    if kw.get("tinylfu"):
        jkw["tinylfu"] = jadm.for_capacity(jcfg.capacity)
        tkw["tinylfu"] = admission.for_capacity(tcfg.capacity)
    vals_mode = "key"
    if kw.get("corrupt"):
        _, _, jst, tst = _replayed()
        jst, _ = jfaults.flip_bit(jst, "keys", seed=5)
        tst, _ = faults.flip_bit(tst, "keys", seed=5)
        jkw["state"], tkw["state"] = jst, tst
        chunks, enabled, vals_mode = chunks[:2], enabled[:2], "any"
    jh_, je, jst_, jsk, jalarm = jrec.validated_replay(
        jcfg, chunks, enabled, vals_mode=vals_mode, **jkw)
    th_, te, tst_, tsk, talarm = validated_replay(
        tcfg, chunks, enabled, backend=backend, vals_mode=vals_mode,
        device="cpu", **tkw)
    np.testing.assert_array_equal(th_.numpy(), np.asarray(jh_))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _assert_state(jst_, tst_)
    assert int(talarm) == int(jalarm)
    assert (int(talarm) != 0) == bool(kw.get("corrupt"))
    if kw.get("tinylfu"):
        for f in ("packed", "door", "additions"):
            np.testing.assert_array_equal(
                _bits(admission.sketch_to_numpy(tsk)[f]),
                _bits(getattr(jsk, f)))


def test_validated_replay_rejects_bad_interval():
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()
    with pytest.raises(ValueError, match="interval"):
        validated_replay(tcfg, chunks, enabled, interval=0, device="cpu")


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------

def _flat_hits(tinylfu=False, ttl=False):
    jcfg, _ = _cfgs()
    be = jmake("jnp", jcfg)
    if ttl:
        chunks, enabled, tt = _ttl_chunks()
        h, _, _, _ = be.replay(be.init(ttl=True), chunks, enabled,
                               ttls=jnp.asarray(tt))
    else:
        chunks, enabled = _chunks()
        h, _, _, _ = be.replay(be.init(), chunks, enabled, tinylfu=(
            jadm.for_capacity(jcfg.capacity) if tinylfu else None))
    return np.asarray(h)


def test_ladder_healthy_lands_on_top_rung():
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()
    c0 = events.cursor()
    out = resilient_replay(tcfg, chunks, enabled, device="cpu")
    assert out.rung == "cuda-resident"
    assert out.attempts == (("cuda-resident", "ok"),)
    assert events.count(start=c0) == 0
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits())
    tl = admission.for_capacity(tcfg.capacity)
    out = resilient_replay(tcfg, chunks, enabled, tinylfu=tl, device="cpu")
    assert out.rung == "cuda-resident" and out.sketch is not None
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits(True))


def test_ladder_smem_breach_takes_scan_rung_with_event():
    """Where kernel 3 does not take the shape (here under a 64-byte
    ``smem_budget``), one ``smem_budget`` event and the ``cuda-scan`` rung,
    with the same hits."""
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()
    c0 = events.cursor()
    with smem_budget(64):
        out = resilient_replay(tcfg, chunks, enabled, device="cpu")
    assert out.rung == "cuda-scan"
    assert ("cuda-resident", "smem_budget") in out.attempts
    assert events.count(component="ladder.replay", reason="smem_budget",
                        start=c0) == 1
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits())


def test_ladder_kernel_failure(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(ops, "replay_resident", boom)
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()
    c0 = events.cursor()
    out = resilient_replay(tcfg, chunks, enabled, device="cpu")
    assert out.rung == "cuda-scan"
    assert ("cuda-resident", "kernel_failure") in out.attempts
    ev = [e for e in events.since(c0) if e.reason == "kernel_failure"][0]
    assert "injected kernel fault" in ev.detail
    assert (ev.fallback_from, ev.fallback_to) == ("cuda-resident",
                                                  "cuda-scan")
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits())


def test_ladder_validator_alarm_descends_then_raises():
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()

    def reject_cuda(st, sk, _n=[0]):
        _n[0] += 1
        return (_n[0] > 2), "forced alarm"   # fail the two cuda rungs

    out = resilient_replay(tcfg, chunks, enabled, validate_fn=reject_cuda,
                           device="cpu")
    assert out.rung == "torch-scan"
    assert out.attempts == (("cuda-resident", "validator_alarm"),
                            ("cuda-scan", "validator_alarm"),
                            ("torch-scan", "ok"))
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits())
    with pytest.raises(RuntimeError, match="last ladder rung"):
        resilient_replay(tcfg, chunks, enabled, device="cpu",
                         validate_fn=lambda st, sk: (False, "always bad"))


def test_ladder_hierarchy_rungs():
    """The hierarchy's top rung (kernel 4's plain version here), equal to
    the reference's hierarchy replay; with TinyLFU it is skipped as
    ``backend_unsupported`` and the flat ladder runs."""
    jcfg, tcfg = _cfgs()
    chunks, enabled = _chunks()
    jhc = jh.HierarchyConfig(l1_sets=4, l1_ways=4)
    thc = th.HierarchyConfig(l1_sets=4, l1_ways=4)
    jhits, _, _, _ = jh.replay_l1_over_l2(jcfg, jhc, jh.make_hier(jcfg, jhc),
                                          chunks, enabled)
    c0 = events.cursor()
    out = resilient_replay(tcfg, chunks, enabled, hierarchy=thc,
                           device="cpu")
    assert out.rung == "cuda-resident-l1l2" and events.count(start=c0) == 0
    assert isinstance(out.state, th.HierState)
    np.testing.assert_array_equal(out.hits.numpy(), np.asarray(jhits))
    tl = admission.for_capacity(tcfg.capacity)
    out = resilient_replay(tcfg, chunks, enabled, tinylfu=tl, hierarchy=thc,
                           device="cpu")
    assert out.attempts[0] == ("cuda-resident-l1l2", "backend_unsupported")
    assert out.rung == "cuda-resident"


def test_ladder_ttl_healthy_and_stale_served_descent():
    _, tcfg = _cfgs()
    chunks, enabled, tt = _ttl_chunks()
    c0 = events.cursor()
    out = resilient_replay(tcfg, chunks, enabled, ttls=tt, device="cpu")
    assert out.attempts == (("cuda-resident", "ok"),)
    assert events.count(component="ladder.replay", start=c0) == 0
    np.testing.assert_array_equal(out.hits.numpy(), _flat_hits(ttl=True))

    def stale_once(st, sk, _n=[0]):
        _n[0] += 1
        if _n[0] == 1:
            return False, "set 0 way 1: expired_hit (meta_a >= expiry)"
        return True, ""

    out = resilient_replay(tcfg, chunks, enabled, ttls=tt, device="cpu",
                           validate_fn=stale_once)
    assert out.rung == "cuda-scan"
    assert ("cuda-resident", "stale_served") in out.attempts
    assert events.count(component="ladder.replay", reason="stale_served",
                        start=c0) == 1
    with pytest.raises(ValueError, match="TinyLFU"):
        resilient_replay(tcfg, chunks, enabled, ttls=tt, device="cpu",
                         tinylfu=admission.for_capacity(tcfg.capacity))


def test_ladder_unsupported_config_takes_the_floor():
    """A sampled policy is refused by the ``cuda`` backend: both cuda
    rungs are skipped with one ``backend_unsupported`` event."""
    tcfg = KWayConfig(num_sets=1, ways=64, sample=8)
    chunks, enabled = _chunks()
    c0 = events.cursor()
    out = resilient_replay(tcfg, chunks, enabled, device="cpu")
    assert out.rung == "torch-scan" == RUNGS[-1]
    assert ("cuda-resident", "backend_unsupported") in out.attempts
    assert events.count(reason="backend_unsupported", start=c0) == 1


@pytest.mark.parametrize("fault", ["kernel_failure", "validator_alarm",
                                   "backend_unsupported"])
def test_ladder_on_the_card_never_gives_way_to_the_twin(monkeypatch, fault):
    """The card's rule, with ``_on_card`` forced on over CPU tensors: a
    kernel's exception reaches the caller with no event, validator alarms
    end at ``cuda-scan``, and only a configuration the ``cuda`` backend
    refuses up front takes ``torch-scan``."""
    from repro_torch.robust import ladder
    monkeypatch.setattr(ladder, "_on_card", lambda dev: True)
    _, tcfg = _cfgs()
    chunks, enabled = _chunks()
    c0 = events.cursor()
    if fault == "kernel_failure":
        def boom(*a, **k):
            raise RuntimeError("injected kernel fault")

        monkeypatch.setattr(ops, "replay_resident", boom)
        with pytest.raises(RuntimeError, match="injected kernel fault"):
            resilient_replay(tcfg, chunks, enabled, device="cpu")
        assert events.count(start=c0) == 0
    elif fault == "validator_alarm":
        with pytest.raises(RuntimeError,
                           match="last ladder rung 'cuda-scan'"):
            resilient_replay(tcfg, chunks, enabled, device="cpu",
                             validate_fn=lambda st, sk: (False, "always bad"))
        assert [(e.reason, e.fallback_from, e.fallback_to)
                for e in events.since(c0)] == [
            ("validator_alarm", "cuda-resident", "cuda-scan"),
            ("validator_alarm", "cuda-scan", "none")]
    else:
        out = resilient_replay(KWayConfig(num_sets=1, ways=64, sample=8),
                               chunks, enabled, device="cpu")
        assert out.rung == "torch-scan"
        assert events.count(reason="backend_unsupported", start=c0) == 1


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tree:
    kstate: tkway.KWayState
    pool: torch.Tensor
    flags: torch.Tensor
    sketch: object = None


def _tree(seed):
    r = np.random.default_rng(seed)
    st = tkway.state_from_numpy(
        {f: r.integers(-5, 5, (4, 2)).astype(np.int32)
         for f in ("keys", "fprint", "vals", "meta_a", "meta_b")}
        | {"clock": np.int32(seed)}, device="cpu")
    pool = torch.from_numpy(r.integers(-2**15, 2**15, (2, 3, 4)).astype(
        np.int16)).view(torch.bfloat16)      # every bit pattern, NaNs too
    return _Tree(kstate=st, pool=pool,
                 flags=torch.from_numpy(r.random(5) < 0.5))


def _tree_bits(t):
    return [(p, x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
            for p, x in manager.flatten(t)]


def test_ckpt_roundtrip_bit_for_bit_in_place(tmp_path):
    src, dst = _tree(1), _tree(2)
    root = str(tmp_path)
    manager.save(root, 5, src, extra={"note": "x"})
    ptrs = [x.data_ptr() for _, x in manager.flatten(dst)]
    out, extra = manager.restore(root, 5, dst)
    assert out is dst and extra == {"note": "x"}
    assert [x.data_ptr() for _, x in manager.flatten(dst)] == ptrs
    for (p, a), (q, b) in zip(_tree_bits(src), _tree_bits(dst)):
        assert p == q and torch.equal(a, b), p
    assert [p for p, _ in manager.flatten(dst)][:2] == [".kstate.keys",
                                                        ".kstate.fprint"]


def test_ckpt_uncommitted_ignored_and_keep_last(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3, 4):
        manager.save(root, step, _tree(step), keep_last=2)
    assert manager.latest_step(root) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003", "step_000000004"]
    tmp = faults.crashed_save(_tree(9), root, 5)
    assert tmp.endswith(".tmp") and manager.latest_step(root) == 4
    with pytest.raises(ValueError, match="no committed checkpoint"):
        manager.restore(root, 5, _tree(0))


def test_ckpt_mismatches_named(tmp_path):
    root = str(tmp_path)
    manager.save(root, 1, _tree(1))
    bad = _tree(1)
    bad.sketch = admission.make_sketch(admission.for_capacity(8), "cpu")
    with pytest.raises(ValueError, match="missing from checkpoint"):
        manager.restore(root, 1, bad)
    bad = _tree(1)
    bad.pool = torch.zeros((2, 3, 5), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        manager.restore(root, 1, bad)


# ---------------------------------------------------------------------------
# the serving tick: check_serve, serve faults, crash-mid-tick restore
# ---------------------------------------------------------------------------

BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96, max_prompt=80)

_MODELS = {}


def _models():
    if not _MODELS:
        cfg = configs.get("deepseek-7b").smoke
        jcfg = jconfigs.get("deepseek-7b").smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _MODELS["m"] = (cfg, jcfg, jparams,
                        lm.params_from_numpy(cfg, tree, device="cpu"))
    return _MODELS["m"]


def _engine(**kw):
    cfg, _, _, model = _models()
    return teng.Engine(cfg, model, teng.EngineConfig(jitted=True,
                                                     **dict(BASE, **kw)),
                       device="cpu")


def _submit_mix(eng, vocab, seed=0, n=6, max_new=8):
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, 40)
    for _ in range(n):
        tail = rng.integers(2, vocab - 1, int(rng.integers(3, 14)))
        eng.submit(np.concatenate([shared, tail]), max_new=max_new)


@pytest.fixture(scope="module")
def ticked():
    """The port's tick and the reference's jitted engine after the same
    three ticks of the same requests, on the same weights."""
    cfg, jcfg, jparams, _ = _models()
    jeng_ = jeng.Engine(jcfg, jparams, jeng.EngineConfig(jitted=True,
                                                         **BASE))
    teng_ = _engine()
    for e in (jeng_, teng_):
        _submit_mix(e, cfg.vocab_size)
        for _ in range(3):
            e.step()
    return jeng_, teng_


def _same_serve_report(trep, jrep):
    _same_cache_report(trep.cache, jrep.cache)
    for f in ("slot_bits", "page_bits", "global_bits", "bits"):
        np.testing.assert_array_equal(_bits(getattr(trep, f)),
                                      _bits(getattr(jrep, f)), err_msg=f)
    assert explain_serve(trep) == jinv.explain_serve(jrep)


def test_check_serve_matches_reference_mid_run(ticked):
    jeng_, teng_ = ticked
    trep = check_serve(teng_.ecfg, teng_._state)
    assert trep.clean(), explain_serve(trep)
    assert bool(teng_._state.active.any())
    _same_serve_report(trep, jinv.check_serve(jeng_.ecfg, jeng_._sstate))


@pytest.mark.parametrize("kind", ["double_book_page", "stale_owner"])
def test_serve_faults_match_reference(ticked, kind):
    jeng_, teng_ = ticked
    jst, jrep = getattr(jfaults, kind)(jeng_.ecfg, jeng_._sstate, seed=3)
    tst, trep = getattr(faults, kind)(teng_.ecfg, teng_._state, seed=3)
    _same_report(trep, jrep)
    rep = check_serve(teng_.ecfg, tst)
    assert not rep.clean()
    _same_serve_report(rep, jinv.check_serve(jeng_.ecfg, jst))
    names = "|".join(explain_serve(rep))
    if kind == "double_book_page":
        assert "double_booked" in names or "dup_page_in_row" in names
    else:
        assert f"private page {trep.index[0]}" in names


def test_inject_nan_matches_reference_on_real_pages(ticked):
    """The port's pools carry a sink page: ``pages=`` draws over the real
    ones, the reference's draw; the sink page is never read as a page."""
    jeng_, teng_ = ticked
    jst, tst = jeng_._sstate, teng_._state
    total = BASE["num_sets"] * BASE["ways"] + BASE["private_pages"]
    jpk, jrep = jfaults.inject_nan(jst.pool_k, seed=1)
    tpk, trep = faults.inject_nan(tst.pool_k, seed=1, pages=total)
    assert trep.index == jrep.index and trep.kind == "nan"
    rep = check_serve(teng_.ecfg, dataclasses.replace(tst, pool_k=tpk))
    assert "serve: nan_in_kv" in explain_serve(rep)
    assert jinv.explain_serve(jinv.check_serve(
        jeng_.ecfg, dataclasses.replace(jst, pool_k=jpk)))[-1] == \
        "serve: nan_in_kv"
    sink = tst.pool_v.clone()
    sink[:, :, total] = float("nan")
    assert check_serve(teng_.ecfg, dataclasses.replace(
        tst, pool_v=sink)).clean()


def test_serve_state_clean_drained():
    eng = _engine()
    _submit_mix(eng, _models()[0].vocab_size, n=4, max_new=4)
    eng.run(max_steps=60)
    rep = check_serve(eng.ecfg, eng._state)
    assert rep.clean(), explain_serve(rep)


def _tokens(eng):
    return {rid: list(r.generated) for rid, r in eng.finished.items()}


@pytest.mark.parametrize("decode_block", [1, 2])
def test_crash_mid_tick_restore_bit_identical(tmp_path, decode_block):
    """Commit at tick 3, run tick 4, crash before its checkpoint commits:
    a fresh engine restored from tick 3 re-emits exactly the uninterrupted
    run's tokens and stats; the restore writes into the engine's own
    buffers (the addresses a captured graph holds)."""
    vocab = _models()[0].vocab_size
    ref = _engine(decode_block=decode_block)
    _submit_mix(ref, vocab)
    ref.run(max_steps=60)

    eng = _engine(decode_block=decode_block)
    _submit_mix(eng, vocab)
    root = str(tmp_path / "ckpt")
    for _ in range(3):
        eng.step()
    save_engine(eng, root, 3)
    eng.step()                                    # tick 4 runs...
    faults.crashed_save(eng._state, root, 4)      # ...its commit never lands
    assert manager.latest_step(root) == 3

    eng2 = _engine(decode_block=decode_block)
    ptrs = [x.data_ptr() for _, x in manager.flatten(eng2._state)]
    state_obj = eng2._state
    assert restore_engine(eng2, root) == 3
    assert eng2._state is state_obj
    assert [x.data_ptr() for _, x in manager.flatten(eng2._state)] == ptrs
    eng2.run(max_steps=60)
    assert _tokens(eng2) == _tokens(ref)
    assert eng2.stats == ref.stats
    assert check_serve(eng2.ecfg, eng2._state).clean()


def test_checkpointed_engine_cadence_and_restore(tmp_path):
    vocab = _models()[0].vocab_size
    eng = _engine()
    _submit_mix(eng, vocab, n=4, max_new=4)
    ck = CheckpointedEngine(eng, str(tmp_path), every=2, keep_last=2)
    fin = ck.run(max_steps=40)
    assert len(fin) == 4
    assert ck.last_committed is not None
    assert manager.latest_step(str(tmp_path)) == ck.last_committed
    c0 = events.cursor()
    eng2 = _engine()
    ck2 = CheckpointedEngine(eng2, str(tmp_path))
    assert ck2.restore() == ck.last_committed
    assert events.count(component="engine.checkpoint", start=c0) == 1
    ck2.run(max_steps=40)
    assert _tokens(eng2) == _tokens(eng)


def test_engine_checkpoint_refusals(tmp_path):
    cfg, _, _, model = _models()
    host = teng.Engine(cfg, model, teng.EngineConfig(**BASE), device="cpu")
    for fn in (lambda: save_engine(host, str(tmp_path), 1),
               lambda: restore_engine(host, str(tmp_path)),
               lambda: CheckpointedEngine(host, str(tmp_path))):
        with pytest.raises(ValueError, match="jitted"):
            fn()
    with pytest.raises(ValueError, match="no committed checkpoint"):
        restore_engine(_engine(), str(tmp_path))
    manager.save(str(tmp_path), 7, _tree(1), extra={"kind": "other"})
    with pytest.raises(ValueError, match="not an engine checkpoint"):
        restore_engine(_engine(), str(tmp_path), 7)
