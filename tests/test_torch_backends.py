"""The port's backends against the reference's ``jnp`` backend.

``torch`` (the tensor twin), ``cuda`` (here on CPU tensors, so the kernels'
plain versions) and ``ref`` (the sequential oracle) of ``repro_torch``
against ``repro``'s ``jnp`` for get / put / access / access_two_phase /
peek_victims: the tests/test_backends.py sweep over 5 policies × soa/aos ×
ways, with duplicate keys and same-set collisions, written as
parametrised cases.  Batch size 1 holds all three port backends to ``jnp``;
at larger batches ``ref`` is a valid serialization only, so ``torch`` and
``cuda`` carry the batched comparison.  All comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import traces as jtraces
from repro.core.backend import make_backend as jmake
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro_torch.core import kway as tkway
from repro_torch.core.backend import available_backends, make_backend
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy

torch.set_num_threads(1)

ALL_POLICIES = list(Policy)
LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock")


def _cfgs(**kw):
    pol = kw.pop("policy")
    return (JConfig(policy=JPolicy(int(pol)), **kw),
            KWayConfig(policy=pol, **kw))


def _assert_state(jst, tst, msg):
    got = tkway.state_to_numpy(tst)
    for leaf in LEAVES:
        np.testing.assert_array_equal(got[leaf], np.asarray(getattr(jst, leaf)),
                                      err_msg=f"{msg}: {leaf}")


def _np(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def _bits(x):
    """Any integer/bool array as its 32-bit pattern, for exact compares
    across uint32 (reference) and int32 (port) key lanes."""
    return np.asarray(_np(x)).astype(np.int64) & 0xFFFFFFFF


def test_registry():
    assert available_backends() == ["cuda", "ref", "torch"]
    with pytest.raises(ValueError):
        make_backend("jnp", KWayConfig(num_sets=4, ways=2), device="cpu")


def test_cuda_backend_rejects_unsupported():
    with pytest.raises(ValueError, match="ways"):
        make_backend("cuda", KWayConfig(num_sets=2, ways=256), device="cpu")
    with pytest.raises(ValueError, match="sample"):
        make_backend("cuda", KWayConfig(num_sets=1, ways=64, sample=8),
                     device="cpu")


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_serial_equivalence(policy, layout):
    """B=1 zipf replay through jnp and all three port backends: identical
    hit / value / eviction sequences and final state."""
    jcfg, tcfg = _cfgs(num_sets=8, ways=4, policy=policy, layout=layout)
    jb = jmake("jnp", jcfg)
    tbs = {n: make_backend(n, tcfg, device="cpu")
           for n in ("torch", "cuda", "ref")}
    js = jb.init()
    ts = {n: be.init() for n, be in tbs.items()}
    trace = np.asarray(jtraces.generate("zipf", 120, seed=int(policy),
                                        catalog=100), np.uint32)
    trace[::13] = 0
    for t in trace:
        k = np.asarray([t], np.uint32)
        v = k.astype(np.int32)
        js, hit, vals, ek, ev = jb.access(js, jnp.asarray(k), jnp.asarray(v))
        want = (bool(hit[0]), int(vals[0]), bool(ev[0]),
                int(ek[0]) if bool(ev[0]) else -1)
        for n, be in tbs.items():
            ts[n], hit, vals, ek, ev = be.access(ts[n], k, v)
            got = (bool(hit[0]), int(vals[0]), bool(ev[0]),
                   int(_np(ek)[0]) if bool(ev[0]) else -1)
            assert got == want, (n, t)
    for n in tbs:
        _assert_state(js, ts[n], n)


#: (operation, batch size) per step: one batch shape keeps the reference's
#: compilations few (they dominate this file's time); 32 lanes over 4 sets
#: force same-set collisions, and enable masks vary the live lanes
STEPS = [("access", 32), ("put", 32), ("get", 32), ("two_phase", 32),
         ("access", 32), ("put", 32), ("access", 32), ("get", 32)]


def _batch(rng, step, b):
    keys = rng.integers(0, 48, b).astype(np.uint32)
    keys[: b // 3] = keys[0]                      # forced duplicates
    en = rng.random(b) < (1.0 if step % 3 else 0.8)
    return keys, en


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("layout,ways", [("soa", 1), ("soa", 4), ("soa", 8),
                                         ("aos", 4)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_ops_match_jnp(policy, layout, ways, backend):
    """Every operation with duplicates, same-set collisions (32 lanes over 4
    sets) and enable masks, step by step from one state."""
    jcfg, tcfg = _cfgs(num_sets=4, ways=ways, policy=policy, layout=layout)
    jb, tb = jmake("jnp", jcfg), make_backend(backend, tcfg, device="cpu")
    js, ts = jb.init(), tb.init()
    rng = np.random.default_rng(int(policy) * 10 + ways)
    for step, (op, b) in enumerate(STEPS):
        keys, en = _batch(rng, step, b)
        vals = keys.astype(np.int32) + 1
        jk, jv = jnp.asarray(keys), jnp.asarray(vals)
        jen = jnp.asarray(en)
        if op in ("access", "two_phase"):
            f = "access" if op == "access" else "access_two_phase"
            js, *jo = getattr(jb, f)(js, jk, jv, enabled=jen)
            ts, *to = getattr(tb, f)(ts, keys, vals, enabled=en)
            jo[2] = np.where(np.asarray(jo[3]), np.asarray(jo[2]), 0)
            to[2] = np.where(to[3].numpy(), _np(to[2]), 0)
        elif op == "get":
            js, *jo = jb.get(js, jk, enabled=jen)
            ts, *to = tb.get(ts, keys, enabled=en)
        else:
            js, *jo = jb.put(js, jk, jv, enabled=jen)
            ts, *to = tb.put(ts, keys, vals, enabled=en)
            jo[0] = np.where(np.asarray(jo[1]), np.asarray(jo[0]), 0)
            to[0] = np.where(to[1].numpy(), _np(to[0]), 0)
        for i, (g, w) in enumerate(zip(to, jo)):
            np.testing.assert_array_equal(
                _bits(g), _bits(w), err_msg=f"step {step} {op}: output {i}")
        _assert_state(js, ts, f"step {step} {op}")
        pk = rng.integers(0, 48, 32).astype(np.uint32)
        jvk, jvv = jb.peek_victims(js, jnp.asarray(pk))
        tvk, tvv = tb.peek_victims(ts, pk)
        np.testing.assert_array_equal(tvv.numpy(), np.asarray(jvv))
        np.testing.assert_array_equal(_np(tvk), np.asarray(jvk))


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_ref_backend_batched_ops_b1(policy):
    """The oracle's get / put / peek at batch size 1, where it is exact."""
    jcfg, tcfg = _cfgs(num_sets=4, ways=2, policy=policy)
    jb, tb = jmake("jnp", jcfg), make_backend("ref", tcfg, device="cpu")
    js, ts = jb.init(), tb.init()
    rng = np.random.default_rng(int(policy))
    for step in range(30):
        k = rng.integers(0, 20, 1).astype(np.uint32)
        if step % 2:
            js, jh, jv = jb.get(js, jnp.asarray(k))
            ts, th, tv = tb.get(ts, k)
            assert (bool(jh[0]), int(jv[0])) == (bool(th[0]), int(tv[0]))
        else:
            js, jek, jev, jss, jsw = jb.put(js, jnp.asarray(k),
                                            jnp.asarray(k.astype(np.int32)))
            ts, tek, tev, tss, tsw = tb.put(ts, k, k.astype(np.int32))
            assert bool(jev[0]) == bool(tev[0])
            assert (int(jss[0]), int(jsw[0])) == (int(tss[0]), int(tsw[0]))
            if bool(jev[0]):
                assert int(jek[0]) == int(_np(tek)[0])
        jvk, jvv = jb.peek_victims(js, jnp.asarray(k))
        tvk, tvv = tb.peek_victims(ts, k)
        assert bool(jvv[0]) == bool(tvv[0])
        if bool(jvv[0]):
            assert int(jvk[0]) == int(_np(tvk)[0])
    _assert_state(js, ts, "ref")


@pytest.mark.parametrize("policy", [Policy.LRU, Policy.LFU, Policy.RANDOM])
def test_sampled_policy_torch_only(policy):
    """Sampled victim selection (sample > 0) on the torch twin."""
    jcfg, tcfg = _cfgs(num_sets=1, ways=64, policy=policy, sample=8)
    jb, tb = jmake("jnp", jcfg), make_backend("torch", tcfg, device="cpu")
    js, ts = jb.init(), tb.init()
    rng = np.random.default_rng(int(policy))
    for step in range(6):
        keys = rng.integers(0, 200, 32).astype(np.uint32)
        keys[:5] = keys[0]
        v = keys.astype(np.int32)
        js, jh, _, jek, jev = jb.access(js, jnp.asarray(keys), jnp.asarray(v))
        ts, th, _, tek, tev = tb.access(ts, keys, v)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    _assert_state(js, ts, "sampled")


def test_slot_value_modes_match_jnp():
    """The cache-as-allocator payload mode of put and access."""
    jcfg, tcfg = _cfgs(num_sets=8, ways=2, policy=Policy.LRU)
    jb, tb = jmake("jnp", jcfg), make_backend("torch", tcfg, device="cpu")
    keys = np.arange(20, dtype=np.uint32) % 13
    z = np.zeros(20, np.int32)
    js, *jo = jb.put(jb.init(), jnp.asarray(keys), jnp.asarray(z),
                     slot_value=True)
    ts, *to = tb.put(tb.init(), keys, z, slot_value=True)
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    _assert_state(js, ts, "slot put")
    for f in ("access", "access_two_phase"):
        j2, _, jv, _, _ = getattr(jb, f)(js, jnp.asarray(keys + 3),
                                         jnp.asarray(z), slot_value=True)
        t2, _, tv, _, _ = getattr(tb, f)(ts, keys + 3, z, slot_value=True)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        _assert_state(j2, t2, f)
