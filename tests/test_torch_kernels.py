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
    """Random numpy state leaves: about a fifth of the ways empty,
    consistent fingerprints, metadata below the clock."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, catalog, (s, ways)).astype(np.uint32)
    keys[rng.random((s, ways)) < 0.2] = 0xFFFFFFFF
    fpr = np.asarray(jh.fingerprint(jnp.asarray(keys)))
    fpr = np.where(keys == 0xFFFFFFFF, 0, fpr).astype(np.uint32)
    clock = 5000
    ma = rng.integers(1, clock, (s, ways)).astype(np.int32)
    mb = rng.integers(0, clock, (s, ways)).astype(np.int32)
    return {"keys": keys, "fprint": fpr, "vals": keys.view(np.int32).copy(),
            "meta_a": ma, "meta_b": mb, "clock": np.int32(clock)}


def _queries(s, b, seed, catalog=64):
    """Keys (with duplicates) plus their sets, times and an enable mask."""
    rng = np.random.default_rng(seed + 1)
    qk = rng.integers(0, catalog, b).astype(np.uint32)
    qk[: b // 4] = qk[0]
    sets = np.asarray(jh.set_index(jnp.asarray(qk), s)).astype(np.int32)
    times = (5000 + np.arange(b)).astype(np.int32)
    en = rng.random(b) < 0.75
    return qk, sets, times, en


def _j_lanes(st):
    return [jnp.asarray(st[f]).astype(jnp.int32)
            for f in ("keys", "fprint", "meta_a", "meta_b")]


def _t_lanes(st):
    t = tkway.state_from_numpy(st, device="cpu")
    return [t.keys, t.fprint, t.meta_a, t.meta_b]


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", [1, 4, 8])
@pytest.mark.parametrize("variant", ["hits", "victim", "order"])
def test_kway_probe_ref_matches_reference(policy, ways, variant):
    s, b = 8, 48                        # 48 queries into 8 sets: collisions
    st = _state(s, ways, seed=ways * 7 + int(policy))
    qk, sets, times, _ = _queries(s, b, seed=ways)
    kw = dict(full_order=variant == "order", need_victims=variant != "hits")
    want = jref.kway_probe_ref(
        *_j_lanes(st), jnp.asarray(sets), jnp.asarray(qk).astype(jnp.int32),
        jnp.asarray(times), policy=JPolicy(int(policy)), ways=ways, **kw)
    got = tref.kway_probe_ref(
        *_t_lanes(st), torch.from_numpy(sets), th.key_tensor(qk, "cpu"),
        torch.from_numpy(times), policy=policy, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("ways", [1, 4, 8])
def test_kway_fused_probe_ref_matches_reference(policy, ways):
    s, b = 8, 48
    st = _state(s, ways, seed=ways * 11 + int(policy))
    qk, sets, tg, en = _queries(s, b, seed=ways + 3)
    tp = tg + b
    want = jref.kway_fused_probe_ref(
        *_j_lanes(st), jnp.asarray(sets), jnp.asarray(qk).astype(jnp.int32),
        jnp.asarray(tg), jnp.asarray(tp), jnp.asarray(en.astype(np.int32)),
        policy=JPolicy(int(policy)), ways=ways)
    got = tref.kway_fused_probe_ref(
        *_t_lanes(st), torch.from_numpy(sets), th.key_tensor(qk, "cpu"),
        torch.from_numpy(tg), torch.from_numpy(tp), torch.from_numpy(en),
        policy=policy)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {i}")


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers compute the plain version and launch no
    kernel (there is none to build here)."""
    st = _state(8, 4, seed=1)
    qk, sets, times, en = _queries(8, 16, seed=1)
    args = (*_t_lanes(st), torch.from_numpy(sets), th.key_tensor(qk, "cpu"))
    before = dict(tkp.LAUNCHES)
    got = tkp.kway_probe(*args, torch.from_numpy(times),
                         policy=Policy.LRU, full_order=True)
    want = tref.kway_probe_ref(*args, torch.from_numpy(times),
                               policy=Policy.LRU, full_order=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tkp.kway_fused_probe(*args, torch.from_numpy(times),
                         torch.from_numpy(times + 16), torch.from_numpy(en),
                         policy=Policy.LFU)
    assert tkp.LAUNCHES == before
    with pytest.raises(ValueError):
        tkp.kway_probe(*args, torch.from_numpy(times), policy=Policy.LRU,
                       full_order=True, need_victims=False)


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
