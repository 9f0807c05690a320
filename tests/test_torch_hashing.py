"""The port's hashing and policies (repro_torch.core) against the reference.

Same inputs, made from a seed with numpy, through ``repro.core.hashing`` /
``repro.core.policies`` and their torch counterparts.  Every comparison is
exact; float32 scores are compared as bit patterns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import policies as jp
from repro_torch.core import hashing as th
from repro_torch.core import policies as tp

torch.set_num_threads(1)

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)


def _keys(seed, n=4096):
    k = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([EDGE, k.astype(np.uint32)])


def _t(keys_u32):
    return th.key_tensor(keys_u32, "cpu")


def _u32(t):
    return t.numpy().astype(np.int64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 0x51CA, 0xF19E, 0xBADA, 0xFFFFFFFF])
def test_hash_u32_matches_reference(seed):
    k = _keys(seed)
    want = np.asarray(jh.hash_u32(jnp.asarray(k), seed))
    np.testing.assert_array_equal(_u32(th.hash_u32(_t(k), seed)), want)
    for key in list(EDGE) + list(k[-8:]):
        assert th.hash_u32_int(int(key), seed) == int(
            jh.hash_u32(jnp.uint32(key), seed))


@pytest.mark.parametrize("num_sets", [1, 16, 4096, 131072])
def test_set_index_fingerprint_sanitize(num_sets):
    k = _keys(num_sets)
    np.testing.assert_array_equal(
        th.set_index(_t(k), num_sets).numpy(),
        np.asarray(jh.set_index(jnp.asarray(k), num_sets)))
    np.testing.assert_array_equal(
        th.fingerprint(_t(k)).numpy(),
        np.asarray(jh.fingerprint(jnp.asarray(k))).astype(np.int32))
    np.testing.assert_array_equal(
        th.sanitize_keys(_t(k)).numpy().view(np.uint32),
        np.asarray(jh.sanitize_keys(jnp.asarray(k))))
    with pytest.raises(ValueError):
        th.set_index(_t(k), 3)


def _meta(seed, n=2048):
    rng = np.random.default_rng(seed)
    keys = _keys(seed, n - len(EDGE))
    a = rng.integers(0, 1 << 24, n).astype(np.int32)
    b = rng.integers(0, 1 << 20, n).astype(np.int32)
    now = (b + rng.integers(0, 1 << 10, n)).astype(np.int32)
    a[:4] = [0, 1, 2**31 - 1, 5]
    now[4:8] = b[4:8] - 1                        # age 0 -> division by zero
    return keys, a, b, now


@pytest.mark.parametrize("policy", list(jp.Policy))
def test_victim_scores_bit_exact(policy):
    keys, a, b, now = _meta(int(policy))
    want = np.asarray(jp.victim_scores(
        policy, jnp.asarray(a), jnp.asarray(b), jnp.asarray(now),
        jnp.asarray(keys)))
    got = tp.victim_scores(tp.Policy(int(policy)), torch.from_numpy(a),
                           torch.from_numpy(b), torch.from_numpy(now),
                           _t(keys)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("policy", list(jp.Policy))
def test_on_hit_on_insert(policy):
    _, a, b, now = _meta(int(policy) + 10, 64)
    ja, jb = jp.on_hit(policy, jnp.asarray(a), jnp.asarray(b),
                       jnp.asarray(now))
    ta, tb = tp.on_hit(tp.Policy(int(policy)), torch.from_numpy(a),
                       torch.from_numpy(b), torch.from_numpy(now))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ia, ib = jp.on_insert(policy, jnp.asarray(now), (64,))
    sa, sb = tp.on_insert(tp.Policy(int(policy)), torch.from_numpy(now),
                          (64,))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(ia))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(ib))
    assert tp.Policy.parse(policy.name) == int(policy)


def _unfmix32(h: int) -> int:
    """Inverse of the murmur3 finalizer on one uint32."""
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = h * pow(0xC2B2AE35, -1, 1 << 32) & m
    h ^= (h >> 13) ^ (h >> 26)
    h = h * pow(0x85EBCA6B, -1, 1 << 32) & m
    return h ^ (h >> 16)


@pytest.mark.parametrize("page", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_block_hashes_match_reference(page, seed):
    """Chain hashes of random prompts, lengths below one page included."""
    rng = np.random.default_rng(seed)
    for n in [0, 1, page - 1, page, 3 * page + 1, 10 * page]:
        toks = rng.integers(0, 1 << 17, max(n, 0)).astype(np.int32)
        want = jh.prefix_block_hashes(toks, page)
        got = th.prefix_block_hashes(toks, page)
        assert got.dtype == np.uint32 and len(got) == n // page
        np.testing.assert_array_equal(got, want)


def test_prefix_block_hashes_fold_the_empty_key():
    """A prompt whose first chain value is 0xFFFFFFFF (the EMPTY key): both
    fold it to 1, and the chain goes on from the folded-away value."""
    x = _unfmix32(0xFFFFFFFF) ^ 0x9E3779B1          # block 1's salt
    tok = (x * pow(16777619, -1, 1 << 32) & 0xFFFFFFFF) ^ 2166136261
    toks = np.array([tok, 5, 77], np.uint32)
    want = jh.prefix_block_hashes(toks, 1)
    got = th.prefix_block_hashes(toks, 1)
    assert got[0] == 1
    np.testing.assert_array_equal(got, want)
