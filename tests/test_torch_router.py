"""The port's set-owner router (``repro_torch.core.router``) against
``repro.core.router``, exactly.

``owner_of``, ``route`` (owner, pos, deferred, routed), ``bucket``,
``bucket_mask`` and ``unscatter`` on the same keys, at D in {1, 2, 4, 8},
with capacity B (never defers), B/2 and 3 (defers), all lanes enabled or a
mask with disabled lanes; and the batched form (a whole ``[steps, B]``
trace routed in one call, sorting along each chunk) equal to routing each
chunk alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro_torch.core import router

torch.set_num_threads(1)

B = 48
NUM_SETS = 64
SEED = 0x51CA


def _keys(seed, shape):
    r = np.random.default_rng(seed)
    keys = r.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    keys.reshape(-1)[::7] = keys.reshape(-1)[0]   # repeated keys
    return keys


def _t(keys):
    return torch.from_numpy(keys.view(np.int32).copy())


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("capacity", [B, B // 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_route_bucket_unscatter_match_reference(num_shards, capacity, masked):
    keys = _keys(num_shards * 10 + capacity, B)
    r = np.random.default_rng(capacity)
    en = r.random(B) < 0.7 if masked else np.ones(B, bool)
    jown = jrouter.owner_of(jnp.asarray(keys), NUM_SETS, num_shards, SEED)
    town = router.owner_of(_t(keys), NUM_SETS, num_shards, SEED)
    np.testing.assert_array_equal(_np(town), np.asarray(jown))
    jplan = jrouter.route(jown, num_shards, capacity, jnp.asarray(en))
    tplan = router.route(town, num_shards, capacity, torch.from_numpy(en))
    for f in ("owner", "pos", "deferred", "enabled", "routed"):
        np.testing.assert_array_equal(_np(getattr(tplan, f)),
                                      np.asarray(getattr(jplan, f)), f)
    if capacity == B:
        assert not _np(tplan.deferred).any()
    elif capacity == 3:      # some bucket holds more than 3 lanes
        assert _np(tplan.deferred).any()
    jkb = jrouter.bucket(jplan, jnp.asarray(keys), num_shards, capacity,
                         jnp.uint32(0))
    tkb = router.bucket(tplan, _t(keys), num_shards, capacity, 0)
    np.testing.assert_array_equal(_np(tkb).view(np.uint32), np.asarray(jkb))
    jm = jrouter.bucket_mask(jplan, num_shards, capacity)
    tm = router.bucket_mask(tplan, num_shards, capacity)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    # results per bucket lane, unscattered back to request order
    vals = np.arange(num_shards * capacity, dtype=np.int32).reshape(
        num_shards, capacity) * 3 + 1
    ju = jrouter.unscatter(jplan, jnp.asarray(vals), jnp.int32(-1))
    tu = router.unscatter(tplan, torch.from_numpy(vals), -1)
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    # a round trip returns every routed key to its lane
    back = router.unscatter(tplan, tkb, 0)
    routed = _np(tplan.routed)
    np.testing.assert_array_equal(_np(back)[routed],
                                  keys.view(np.int32)[routed])


@pytest.mark.parametrize("num_shards,capacity", [(1, B), (4, B), (8, 5)])
def test_batched_route_equals_per_chunk(num_shards, capacity):
    """One call over a [steps, B] trace == routing each chunk alone."""
    steps = 6
    keys = _keys(99 + num_shards, (steps, B))
    en = np.random.default_rng(1).random((steps, B)) < 0.8
    own = router.owner_of(_t(keys), NUM_SETS, num_shards, SEED)
    plan = router.route(own, num_shards, capacity, torch.from_numpy(en))
    kb = router.bucket(plan, _t(keys), num_shards, capacity, 0)
    eb = router.bucket_mask(plan, num_shards, capacity)
    assert kb.shape == eb.shape == (steps, num_shards, capacity)
    for t in range(steps):
        p = router.route(own[t], num_shards, capacity,
                         torch.from_numpy(en[t]))
        for f in ("owner", "pos", "deferred"):
            np.testing.assert_array_equal(_np(getattr(plan, f))[t],
                                          _np(getattr(p, f)))
        np.testing.assert_array_equal(
            _np(kb[t]), _np(router.bucket(p, _t(keys[t]), num_shards,
                                          capacity, 0)))
        np.testing.assert_array_equal(
            _np(eb[t]), _np(router.bucket_mask(p, num_shards, capacity)))


def test_pad_chunks_matches_reference():
    tr = _keys(5, 101)
    for a, b in zip(router.pad_chunks(tr, 16), jrouter.pad_chunks(tr, 16)):
        np.testing.assert_array_equal(a, b)
