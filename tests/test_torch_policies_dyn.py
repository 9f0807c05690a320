"""The leftovers of the core slices that the eval sweep needs: the
policy-as-tensor forms (``policies.*_dyn``) against the static forms, bit
for bit, for every policy and for policies mixed per lane;
``kway.fully_associative`` / ``pack_aos`` / ``unpack_aos`` against the
reference; and ``backend.smem_budget`` (the counterpart of
``vmem_budget``) on kernel 3's size rule and the ``cuda`` replay."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kway as ref_kway
from repro.core.policies import Policy as RefPolicy
from repro_torch.core import backend, kway
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import (Policy, on_hit, on_hit_dyn, on_insert,
                                       on_insert_dyn, victim_scores,
                                       victim_scores_dyn)
from repro_torch.kernels import replay as krp
from repro_torch.robust import events

NOWS = [0, 1, 7, 2**31 - 1, -2**31, -5]


def _meta(seed, shape=(6, 16)):
    rng = np.random.default_rng(seed)
    i32 = dict(dtype=np.int64)
    ma = rng.integers(-2**31, 2**31, shape, **i32).astype(np.int32)
    mb = rng.integers(-2**31, 2**31, shape, **i32).astype(np.int32)
    keys = rng.integers(-2**31, 2**31, shape, **i32).astype(np.int32)
    ma[0] = rng.integers(0, 40, shape[1])            # small counts too
    mb[1] = ma[1] - 1                                # age 0 + 1
    return torch.from_numpy(ma), torch.from_numpy(mb), torch.from_numpy(keys)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("now", NOWS)
def test_victim_scores_dyn_equals_static(policy, now):
    ma, mb, keys = _meta(int(policy) * 31 + now % 97)
    now_t = torch.tensor(now, dtype=torch.int32)
    pidx = torch.full((ma.shape[0], 1), int(policy), dtype=torch.int32)
    got = victim_scores_dyn(pidx, ma, mb, now_t, keys)
    want = victim_scores(policy, ma, mb, now_t, keys)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("now", NOWS)
def test_dyn_forms_mix_policies_per_lane(now):
    ma, mb, keys = _meta(now % 101, shape=(10, 8))
    now_t = torch.tensor(now, dtype=torch.int32)
    pidx = torch.tensor([p % 5 for p in range(10)], dtype=torch.int32)
    scores = victim_scores_dyn(pidx[:, None], ma, mb, now_t, keys)
    ha, hb = on_hit_dyn(pidx, ma[:, 0], mb[:, 0], now_t)
    ia, ib = on_insert_dyn(pidx, now_t, (10,))
    for lane in range(10):
        p = Policy(int(pidx[lane]))
        want = victim_scores(p, ma[lane], mb[lane], now_t, keys[lane])
        assert torch.equal(_bits(scores[lane]), _bits(want))
        wa, wb = on_hit(p, ma[lane, 0], mb[lane, 0], now_t)
        assert int(ha[lane]) == int(wa) and int(hb[lane]) == int(wb)
        xa, xb = on_insert(p, now_t, ())
        assert int(ia[lane]) == int(xa) and int(ib[lane]) == int(xb)


@pytest.mark.parametrize("subset", [(Policy.LRU, Policy.LFU,
                                     Policy.HYPERBOLIC),
                                    (Policy.RANDOM,), (Policy.FIFO,
                                                       Policy.HYPERBOLIC)])
def test_dyn_forms_over_a_policy_subset(subset):
    """Candidates restricted to the lanes' policies give the same bits."""
    ma, mb, keys = _meta(len(subset), shape=(9, 8))
    now = torch.tensor(777, dtype=torch.int32)
    pidx = torch.tensor([int(subset[i % len(subset)]) for i in range(9)],
                        dtype=torch.int32)
    for got, want in (
            (victim_scores_dyn(pidx[:, None], ma, mb, now, keys, subset),
             victim_scores_dyn(pidx[:, None], ma, mb, now, keys)),
            (on_hit_dyn(pidx, ma[:, 0], mb[:, 0], now, subset),
             on_hit_dyn(pidx, ma[:, 0], mb[:, 0], now)),
            (on_insert_dyn(pidx, now, (9,), policies=subset),
             on_insert_dyn(pidx, now, (9,)))):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("policy", list(Policy))
def test_on_hit_and_insert_dyn_equal_static(policy):
    ma, mb, _ = _meta(int(policy))
    now = torch.tensor(12345, dtype=torch.int32)
    pidx = torch.full(ma.shape, int(policy), dtype=torch.int32)
    for got, want in zip(on_hit_dyn(pidx, ma, mb, now),
                         on_hit(policy, ma, mb, now)):
        assert torch.equal(got, want.expand(got.shape))
    for got, want in zip(on_insert_dyn(pidx, now, tuple(ma.shape)),
                         on_insert(policy, now, tuple(ma.shape))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("policy", list(Policy))
def test_dyn_forms_equal_reference_dyn(policy):
    """Against ``repro.core.policies.*_dyn`` on the same inputs."""
    from repro.core import policies as rp
    ma, mb, keys = _meta(7 + int(policy))
    now = 99991
    got = victim_scores_dyn(torch.tensor(int(policy)), ma, mb,
                            torch.tensor(now, dtype=torch.int32), keys)
    want = rp.victim_scores_dyn(
        jnp.int32(int(policy)), jnp.asarray(ma.numpy()),
        jnp.asarray(mb.numpy()), jnp.int32(now),
        jnp.asarray(keys.numpy().view(np.uint32)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("capacity,sample", [(64, 0), (1024, 8)])
def test_fully_associative(capacity, sample):
    cfg = kway.fully_associative(capacity, Policy.LFU, sample=sample)
    ref = ref_kway.fully_associative(capacity, RefPolicy.LFU, sample=sample)
    assert (cfg.num_sets, cfg.ways, cfg.sample, int(cfg.policy)) == (
        ref.num_sets, ref.ways, ref.sample, int(ref.policy))


def test_pack_unpack_aos_round_trip_and_reference():
    cfg = KWayConfig(num_sets=16, ways=4, policy=Policy.HYPERBOLIC)
    st = kway.make_cache(cfg, device="cpu")
    keys = torch.arange(40, dtype=torch.int32) * 977 - 3
    keys[5] = -1                                     # the sentinel folds
    st, *_ = kway.access(cfg, st, keys, keys)
    rec = kway.pack_aos(st)
    assert rec.shape == (16, 4, 4) and rec.dtype == torch.int32
    back = kway.unpack_aos(rec, st.clock)
    for lane in kway.STATE_LANES:
        assert torch.equal(getattr(back, lane), getattr(st, lane)) or \
            lane == "fprint"
    occupied = st.keys != -1
    assert torch.equal(back.fprint[occupied], st.fprint[occupied])
    ref_state = ref_kway.unpack_aos(jnp.asarray(rec.numpy()),
                                    jnp.asarray(st.clock.numpy()))
    np.testing.assert_array_equal(
        back.fprint.numpy().view(np.uint32), np.asarray(ref_state.fprint))
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(ref_kway.pack_aos(ref_state)))


def test_smem_budget_holds_resident_fits_and_restores():
    cfg = KWayConfig(num_sets=128, ways=8)
    need = krp.resident_smem_bytes(cfg, 64, False)
    assert backend.SMEM_BUDGET is None
    assert krp.resident_fits(cfg, 64, False, "cpu")
    assert krp.smem_limit("cpu") is None
    with backend.smem_budget(need):
        assert krp.resident_fits(cfg, 64, False, "cpu")
        assert krp.smem_limit("cpu") == need
        with backend.smem_budget(need - 1):
            assert not krp.resident_fits(cfg, 64, False, "cpu")
        assert backend.SMEM_BUDGET == need
    assert backend.SMEM_BUDGET is None
    with pytest.raises(RuntimeError):
        with backend.smem_budget(0):
            raise RuntimeError("mid-measurement")
    assert backend.SMEM_BUDGET is None


def test_smem_budget_sends_cuda_replay_to_the_chunked_path():
    """Under ``smem_budget(0)`` the ``cuda`` backend's replay records one
    ``smem_budget`` event and returns the chunked path's results."""
    from repro_torch.core import router, traces
    cfg = KWayConfig(num_sets=16, ways=4)
    chunks, en = router.pad_chunks(traces.generate("zipf", 200, seed=3), 8)
    be = backend.make_backend("cuda", cfg, "cpu")
    want, _, _, _ = be.replay(be.init(), chunks, en)
    c0 = events.cursor()
    with backend.smem_budget(0):
        got, _, _, _ = be.replay(be.init(), chunks, en)
    evs = events.since(c0)
    assert torch.equal(got, want)
    assert [(e.reason, e.fallback_to) for e in evs] == [
        ("smem_budget", "cuda-scan")]
    assert "limit 0" in evs[0].detail
