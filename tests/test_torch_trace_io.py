"""Trace ingestion of the port against ``repro.core.trace_io``.

The committed fixtures (ARC/LIRS and Twitter CSV, with and without a TTL
column) parse to the same keys, TTLs and fingerprints in both packages;
registered fixture families serve the same requests through
``traces.generate`` / ``generate_ttl``; and the family registry keeps its
rules (built-ins cannot be shadowed or removed).
"""
import os

import numpy as np
import pytest

from repro.core import trace_io as jio
from repro.core import traces as jtraces
from repro_torch.core import trace_io as tio
from repro_torch.core import traces as ttraces

FIXTURES = ["lirs_two_pools.trace", "sample_arc.trace", "sample_twitter.csv",
            "sample_twitter_ttl.csv"]


def test_fixture_dir_is_the_repos():
    assert os.path.samefile(tio.fixture_dir(), jio.fixture_dir())


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("with_ttl", [False, True], ids=["keys", "ttl"])
def test_load_trace_matches_reference(name, with_ttl):
    path = os.path.join(tio.fixture_dir(), name)
    got = tio.load_trace(path, with_ttl=with_ttl)
    want = jio.load_trace(path, with_ttl=with_ttl)
    if with_ttl:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].dtype == np.int32
        got, want = got[0], want[0]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32
    assert tio.trace_fingerprint(got) == jio.trace_fingerprint(want)
    head = tio.load_trace(path, limit=5)
    np.testing.assert_array_equal(head, jio.load_trace(path, limit=5))


def test_lirs_two_pools_fingerprint():
    keys = tio.load_trace(os.path.join(tio.fixture_dir(),
                                       "lirs_two_pools.trace"))
    assert tio.trace_fingerprint(keys) == "e76f5e99"


def test_fingerprint_keys_matches_reference():
    keys = ["user:1", "", "ключ", "a" * 300, "x\x00y"] + [
        f"k{i}" for i in range(200)]
    np.testing.assert_array_equal(tio.fingerprint_keys(keys),
                                  jio.fingerprint_keys(keys))


def test_csv_op_filter_matches_reference():
    path = os.path.join(tio.fixture_dir(), "sample_twitter.csv")
    np.testing.assert_array_equal(tio.load_trace(path, ops=tio.READ_OPS),
                                  jio.load_trace(path, ops=jio.READ_OPS))


def test_registered_fixtures_serve_the_same_requests():
    names = tio.register_fixture_traces()
    assert set(names) == set(jio.register_fixture_traces())
    try:
        for name in names:
            for n in (7, 20000):          # a head, and the file tiled
                np.testing.assert_array_equal(
                    ttraces.generate(name, n), jtraces.generate(name, n))
        k1, t1 = ttraces.generate_ttl("sample_twitter_ttl", 50)
        k2, t2 = jtraces.generate_ttl("sample_twitter_ttl", 50)
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(t1, t2)
    finally:
        for name in names:
            tio.unregister_trace(name)
            jio.unregister_trace(name)
    assert "lirs_two_pools" not in ttraces.FAMILIES
    assert "sample_twitter_ttl" not in ttraces.TTL_FAMILIES


def test_builtin_families_cannot_be_shadowed_or_removed():
    with pytest.raises(ValueError, match="shadow"):
        ttraces.register_family("zipf", lambda rng, n: np.zeros(n))
    with pytest.raises(ValueError, match="built-in"):
        ttraces.unregister_family("zipf")
    ttraces.register_family("tmp_family", lambda rng, n: np.arange(n))
    np.testing.assert_array_equal(ttraces.generate("tmp_family", 4),
                                  np.arange(4, dtype=np.uint32))
    ttraces.unregister_family("tmp_family")
    with pytest.raises(ValueError, match="unknown trace family"):
        ttraces.generate("tmp_family", 4)


def test_malformed_and_empty_traces_raise(tmp_path):
    bad = tmp_path / "bad.trace"
    bad.write_text("12\nnot-a-key\n")
    with pytest.raises(ValueError, match="bad.trace:2"):
        tio.load_trace(str(bad))
    empty = tmp_path / "empty.csv"
    empty.write_text("\n\n")
    with pytest.raises(ValueError, match="empty trace"):
        tio.load_trace(str(empty))
