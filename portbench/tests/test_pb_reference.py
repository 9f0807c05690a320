"""The frozen references agree with the port at small sizes: the k-way
cache (access with duplicates, disabled lanes and slot values; whole
replays), the prefix keys, and the float32 forward."""
import numpy as np
import pytest
import torch

from reference import dense_lm
from reference import kway as kref

SETS, WAYS = 64, 8


def _port():
    from repro_torch.core import kway
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    cfg = KWayConfig(num_sets=SETS, ways=WAYS)
    return kway, make_backend("torch", cfg, "cpu")


def _lanes_equal(state, ref):
    want = ref.lanes(0)
    for f in ("keys", "fprint", "vals", "meta_a", "meta_b"):
        assert torch.equal(getattr(state, f), want[f]), f
    assert int(state.clock) == ref.clock_of(0)


@pytest.mark.parametrize("slot_value", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_access_matches_port(seed, slot_value):
    _, be = _port()
    rng = np.random.default_rng(seed)
    st = be.init()
    ref = kref.empty(1, SETS, WAYS, "cpu")
    for step in range(40):
        b = int(rng.integers(1, 300))
        # few distinct keys: duplicates, full sets and evictions; and the
        # empty marker itself
        keys = rng.integers(0, 700, b).astype(np.uint32)
        keys[rng.random(b) < 0.01] = 0xFFFFFFFF
        q = torch.from_numpy(keys.view(np.int32))
        vals = torch.from_numpy(rng.integers(-5, 5, b).astype(np.int32))
        en = torch.from_numpy(rng.random(b) < 0.9)
        st, hit, ans, ek, ev = be.access(st, q, vals, enabled=en,
                                         slot_value=slot_value)
        rh, ra, rek, rev = kref.access(ref, q[None], vals[None], en[None],
                                       slot_value=slot_value)
        assert torch.equal(hit, rh[0]) and torch.equal(ans, ra[0])
        assert torch.equal(ev, rev[0])
        assert torch.equal(ek[ev], rek[0][rev[0]])
    _lanes_equal(st, ref)


def test_replay_matches_port():
    _, be = _port()
    rng = np.random.default_rng(7)
    chunks = torch.from_numpy(
        rng.zipf(1.3, (2, 50, 64)).astype(np.int32) % 5000)
    ref = kref.empty(2, SETS, WAYS, "cpu")
    hits, evs = kref.replay(ref, chunks)
    en = torch.ones((50, 64), dtype=torch.bool)
    for g in range(2):
        h, e, st, _ = be.replay(be.init(), chunks[g], en)
        assert torch.equal(h, hits[g]) and torch.equal(e, evs[g])
        want = ref.lanes(g)
        for f in ("keys", "vals", "meta_a"):
            assert torch.equal(getattr(st, f), want[f])


def test_control_breaks_the_guarantee():
    rng = np.random.default_rng(3)
    chunks = torch.from_numpy(rng.integers(0, 2000, (1, 30, 128)).astype(
        np.int32))
    a, b = kref.empty(1, SETS, WAYS, "cpu"), kref.empty(1, SETS, WAYS, "cpu")
    ha, ea = kref.replay(a, chunks)
    hb, eb = kref.replay(b, chunks, batch_clock=True)
    assert not torch.equal(a.lane("stamp"), b.lane("stamp"))


@pytest.mark.parametrize("n", [0, 15, 16, 17, 100, 768])
def test_prefix_keys_match_port(n):
    from repro_torch.core import hashing
    toks = np.random.default_rng(n).integers(2, 102399, n).astype(np.int32)
    want = hashing.prefix_block_hashes(toks, 16).view(np.int32)
    assert np.array_equal(kref.prefix_block_keys(toks, 16), want)


def test_hash_matches_port():
    from repro_torch.core import hashing
    k = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, 5000, dtype=np.int64))
    for seed in (kref.SET_SEED, kref.FP_SEED):
        assert torch.equal(kref.hash32(k, seed), hashing.hash_u32(k, seed))


def test_forward_matches_port_in_float32():
    """The program's prefill with float32 weights against the reference's
    forward: the same model to rounding."""
    import small
    from bench import drive_serve
    from repro_torch.serve import paged_model as pm
    c = small.config("serve-sessions")
    w = drive_serve.draw_weights(c, 5, "cpu")
    w32 = {k: v.float() for k, v in w.items()}
    cfg, model = drive_serve.program_model("small", c, w32)
    toks = np.random.default_rng(0).integers(2, 511, (2, 40))
    lengths = [40, 23]
    logits, _, _ = pm.prefill_padded(cfg, model, torch.from_numpy(toks),
                                     torch.tensor(lengths))
    ref = dense_lm.logits_at(w, drive_serve.shapes(c),
                             [list(t[:n]) for t, n in zip(toks, lengths)],
                             [[n - 1] for n in lengths])
    for i in range(2):
        torch.testing.assert_close(logits[i], ref[i][0], atol=1e-4,
                                   rtol=1e-4)
