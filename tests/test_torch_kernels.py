"""Plain versions of the port's probe kernels against the reference.

``repro_torch.kernels.ref`` (what kernels 1 and 2 compute, in torch)
against ``repro.kernels.ref`` over all five policies and every variant,
with empty ways, duplicate and same-set queries and enable masks; and one
tiny case through ``repro.kernels.ops`` with the Pallas kernels themselves
(interpret mode on the CPU, as tests/test_kernels.py runs them) against
``repro_torch.kernels.ops`` on CPU tensors.  All comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core.kway import KWayConfig as JConfig
from repro.core.kway import KWayState as JState
from repro.core.policies import Policy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import hashing as th
from repro_torch.core import kway as tkway
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.kernels import kway_probe as tkp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ALL_POLICIES = list(Policy)


def _state(s, ways, seed, catalog=64):
    """Random numpy state leaves: about a fifth of the ways empty, some
    holding 0xFFFFFFFE (the sanitized EMPTY key), consistent fingerprints,
    metadata below the clock."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, catalog, (s, ways)).astype(np.uint32)
    keys[rng.random((s, ways)) < 0.05] = 0xFFFFFFFE
    keys[rng.random((s, ways)) < 0.2] = 0xFFFFFFFF
    fpr = np.asarray(jh.fingerprint(jnp.asarray(keys)))
    fpr = np.where(keys == 0xFFFFFFFF, 0, fpr).astype(np.uint32)
    clock = 5000
    ma = rng.integers(1, clock, (s, ways)).astype(np.int32)
    mb = rng.integers(0, clock, (s, ways)).astype(np.int32)
    return {"keys": keys, "fprint": fpr, "vals": keys.view(np.int32).copy(),
            "meta_a": ma, "meta_b": mb, "clock": np.int32(clock)}


def _raw_queries(b, seed, catalog=64):
    """Raw keys with duplicates and EMPTY (0xFFFFFFFF, which the route
    folds onto 0xFFFFFFFE), and an enable mask."""
    rng = np.random.default_rng(seed + 1)
    qk = rng.integers(0, catalog, b).astype(np.uint32)
    qk[: b // 4] = qk[0]
    qk[rng.random(b) < 0.1] = 0xFFFFFFFF
    en = rng.random(b) < 0.75
    return qk, en


def _j_route(s, qk, clock):
    """The reference's route (``repro.kernels.ops._probe_impl``): sanitized
    keys, sets and the get-phase times."""
    jq = jh.sanitize_keys(jnp.asarray(qk))
    sets = jh.set_index(jq, s, 0x51CA)
    times = clock + jnp.arange(len(qk), dtype=jnp.int32)
    return jq, sets, times


def _j_lanes(st):
    return [jnp.asarray(st[f]).astype(jnp.int32)
            for f in ("keys", "fprint", "meta_a", "meta_b")]


def _t_lanes(st):
    t = tkway.state_from_numpy(st, device="cpu")
    return [t.keys, t.fprint, t.meta_a, t.meta_b]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        w = np.asarray(w).astype(np.int64).astype(g.dtype) \
            if g.dtype != np.bool_ else np.asarray(w).astype(bool)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: output {i}")


#: the route's outputs: sanitized keys (int32 bit patterns) and sets
def _routed(jq, sets):
    return (np.asarray(jq).view(np.int32), np.asarray(sets))


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", [1, 4, 8, 32, 128])
@pytest.mark.parametrize("variant", ["hits", "victim", "order"])
def test_kway_probe_ref_matches_reference(policy, ways, variant):
    """Kernel 1's plain version routes raw keys itself: == the reference's
    route, then its ``kway_probe_ref``, at B 1 and 257 (collisions,
    duplicates, EMPTY keys), 8 sets."""
    s = 8
    st = _state(s, ways, seed=ways * 7 + int(policy))
    kw = dict(full_order=variant == "order", need_victims=variant != "hits")
    for b in (1, 257):
        qk, _ = _raw_queries(b, seed=ways + b)
        jq, sets, times = _j_route(s, qk, int(st["clock"]))
        want = jref.kway_probe_ref(
            *_j_lanes(st), sets, jq.astype(jnp.int32), times,
            policy=JPolicy(int(policy)), ways=ways, **kw)
        tst = tkway.state_from_numpy(st, device="cpu")
        got = tref.kway_probe_ref(
            *_t_lanes(st), th.key_tensor(qk, "cpu"), tst.clock,
            num_sets=s, seed=0x51CA, policy=policy, **kw)
        _same(got, _routed(jq, sets) + tuple(want), f"B={b}")


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", [1, 4, 8, 32, 128])
def test_kway_fused_probe_ref_matches_reference(policy, ways):
    """Kernel 2's plain version routes raw keys itself: == the reference's
    route, then its ``kway_fused_probe_ref`` with the put times t+B+i, at
    B 1 and 257, with an enable mask and with none."""
    s = 8
    st = _state(s, ways, seed=ways * 11 + int(policy))
    tst = tkway.state_from_numpy(st, device="cpu")
    for b in (1, 257):
        qk, en = _raw_queries(b, seed=ways + 3 + b)
        jq, sets, tg = _j_route(s, qk, int(st["clock"]))
        for mask in (en, None):
            jen = jnp.ones(b, jnp.int32) if mask is None \
                else jnp.asarray(mask.astype(np.int32))
            want = jref.kway_fused_probe_ref(
                *_j_lanes(st), sets, jq.astype(jnp.int32), tg, tg + b, jen,
                policy=JPolicy(int(policy)), ways=ways)
            got = tref.kway_fused_probe_ref(
                *_t_lanes(st), th.key_tensor(qk, "cpu"), tst.clock,
                None if mask is None else torch.from_numpy(mask),
                num_sets=s, seed=0x51CA, policy=policy)
            _same(got, _routed(jq, sets) + tuple(want),
                  f"B={b} en={mask is not None}")
        if policy in (Policy.LRU, Policy.LFU, Policy.HYPERBOLIC):
            assert torch.equal(tst.meta_a, torch.from_numpy(st["meta_a"]))


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers compute the plain version and launch no
    kernel (there is none to build here)."""
    st = tkway.state_from_numpy(_state(8, 4, seed=1), device="cpu")
    qk, en = _raw_queries(16, seed=1)
    args = (st.keys, st.fprint, st.meta_a, st.meta_b,
            th.key_tensor(qk, "cpu"), st.clock)
    route = dict(num_sets=8, seed=0x51CA)
    before = dict(tkp.LAUNCHES)
    got = tkp.kway_probe(*args, policy=Policy.LRU, full_order=True, **route)
    want = tref.kway_probe_ref(*args, policy=Policy.LRU, full_order=True,
                               **route)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tkp.kway_fused_probe(*args, torch.from_numpy(en), policy=Policy.LFU,
                         **route)
    assert tkp.LAUNCHES == before
    with pytest.raises(ValueError):
        tkp.kway_probe(*args, policy=Policy.LRU, full_order=True,
                       need_victims=False, **route)


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.HYPERBOLIC])
def test_ops_match_pallas_kernels_interpret(policy):
    """S=16, ways=4, B=8 through the Pallas kernels themselves."""
    s, ways, b = 16, 4, 8
    st = _state(s, ways, seed=int(policy) + 40, catalog=40)
    qk = np.random.default_rng(3).integers(0, 40, b).astype(np.uint32)
    qk[1] = qk[0]
    en = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    jcfg = JConfig(num_sets=s, ways=ways, policy=JPolicy(int(policy)))
    tcfg = KWayConfig(num_sets=s, ways=ways, policy=policy)
    jst = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = tkway.state_from_numpy(st, device="cpu")
    jq, tq = jnp.asarray(qk), th.key_tensor(qk, "cpu")

    def same(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            g = g.numpy()
            if w.dtype == np.uint32:
                g = g.view(np.uint32)
            np.testing.assert_array_equal(g, w.astype(g.dtype))

    same(tops.probe(tcfg, tst, tq), jops.probe(jcfg, jst, jq))
    same(tops.probe_hits(tcfg, tst, tq), jops.probe_hits(jcfg, jst, jq))
    same(tops.probe_orders(tcfg, tst, tq), jops.probe_orders(jcfg, jst, jq))
    same(tops.fused_probe(tcfg, tst, tq, torch.from_numpy(en)),
         jops.fused_probe(jcfg, jst, jq, jnp.asarray(en)))
