"""The port's sampler (``core/prng.py``, ``serve/engine._sample_next``)
against the reference's ``jax.random`` draws, and both serving modes of the
port against both of the reference's, sampling and with experts.

* The threefry words of ``prng_key`` / ``fold_in`` / ``random_bits`` equal
  ``jax.random``'s, and so do the uniforms; the Gumbel draws agree to a
  float32 ulp or two (``log`` rounds differently in the two libraries).
* ``_sample_next`` draws the reference's tokens: 64 decode steps x 8
  lanes x 512 words at temperatures 0.5, 0.8 and 2.0, and the argmax at 0.
* The port's host loop and tick (``device="cpu"``) against the
  reference's host loop and jitted engine, run live on the reference's
  weights: its ``sampled`` and ``burst-sampled`` engine tests
  (``tests/test_serve_jitted.py``), and mixtral's smoke config with
  ``moe_ff_shards=2``, greedy and sampled.  Generated tokens, stats and
  hit ratio equal.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.serve import engine as teng

torch.set_num_threads(1)


def _key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed,data", [
    (0, 0), (3, 7), (3, 2**31 - 1), (123456, 40),
    # seeds past int32 either way wrap to their low 32 bits, as JAX's do
    *((seed, 7) for seed in (-1, -5, -2**31 - 1, -2**63, 2**31, 2**32 - 1,
                             2**32, 2**32 + 5, 2**40, 2**63 - 1))])
def test_prng_key_and_fold_in_match_jax(seed, data):
    key = prng.fold_in(prng.prng_key(seed), data)
    want = _key_words(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         jnp.asarray(data, jnp.int32)))
    np.testing.assert_array_equal(key.numpy(), want)
    assert prng.prng_key(seed) == tuple(_key_words(jax.random.PRNGKey(seed)))
    dev_step = prng.fold_in(prng.prng_key(seed), torch.tensor(
        data, dtype=torch.int32))
    assert torch.equal(dev_step, key)


@pytest.mark.parametrize("seed", [2**63, -2**63 - 1, 2**64])
def test_prng_key_rejects_seeds_past_64_bits(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.prng_key(seed)


@pytest.mark.parametrize("shape", [(5,), (2, 5), (8, 512), (3, 7, 11)])
def test_bits_uniform_gumbel_match_jax(shape):
    """Bits and uniforms equal word for word; the Gumbel draw within two
    float32 ulps."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    key = prng.fold_in(prng.prng_key(3), 9)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    # one compile for the three draws (eager, each would compile alone)
    bits, uni, gum = jax.jit(lambda k: (
        jax.random.bits(k, shape, jnp.uint32),
        jax.random.uniform(k, shape, jnp.float32, minval=tiny, maxval=1.0),
        jax.random.gumbel(k, shape, jnp.float32)))(jkey)
    np.testing.assert_array_equal(prng.random_bits(key, shape).numpy(),
                                  np.asarray(bits).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(key, shape).numpy(),
                                  np.asarray(uni))
    np.testing.assert_allclose(prng.gumbel(key, shape).numpy(),
                               np.asarray(gum), rtol=2.5e-7, atol=5e-7)


@pytest.mark.parametrize("temperature", [0.0, 0.5, 0.8, 2.0])
def test_sample_next_matches_reference(temperature):
    """64 steps x 8 lanes x 512 words: every token equal, with the step
    given as an int (the host loop) and as a 0-d tensor (the tick)."""
    r = np.random.default_rng(int(temperature * 10))
    jcfg = jeng.EngineConfig(temperature=temperature, sample_seed=3)
    tcfg = teng.EngineConfig(temperature=temperature, sample_seed=3)
    jfn = jax.jit(partial(jeng._sample_next, jcfg))
    for step in range(64):
        logits = (r.standard_normal((8, 512)) * 3).astype(np.float32)
        want = np.asarray(jfn(jnp.asarray(logits), step))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = teng._sample_next(tcfg, torch.from_numpy(logits), s)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the engines, run live
# ---------------------------------------------------------------------------

BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96, max_prompt=80)

_MODELS = {}


def _models(arch, **replace):
    key = (arch, tuple(sorted(replace.items())))
    if key not in _MODELS:
        cfg = dataclasses.replace(configs.get(arch).smoke, **replace)
        jcfg = dataclasses.replace(jconfigs.get(arch).smoke, **replace)
        # op by op, without compiling the whole init
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _MODELS[key] = (cfg, jcfg, jparams,
                        lm.params_from_numpy(cfg, tree, device="cpu"))
    return _MODELS[key]


def _workload(vocab, eng, seed=0, n=8, shared_len=40, max_new=6):
    """The reference tests' shared-prefix mix -> (tokens by rid, hit
    ratio, stats)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab - 1, shared_len)
    for _ in range(n):
        tail = rng.integers(2, vocab - 1, int(rng.integers(3, 14)))
        eng.submit(np.concatenate([shared, tail]), max_new=max_new)
    fin = eng.run()
    return ({rid: list(r.generated) for rid, r in fin.items()},
            eng.hit_ratio(), eng.stats)


CASES = {
    "sampled": ("deepseek-7b", {}, dict(temperature=0.8, sample_seed=3)),
    "burst-sampled": ("deepseek-7b", {}, dict(decode_block=4,
                                              temperature=0.8)),
    "mixtral-fs2-greedy": ("mixtral-8x22b", dict(moe_ff_shards=2), {}),
    "mixtral-fs2-sampled": ("mixtral-8x22b", dict(moe_ff_shards=2),
                            dict(temperature=0.8, sample_seed=3)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """The case's four runs: reference host loop and jitted engine, port
    host loop and tick."""
    arch, replace, kw = CASES[request.param]
    cfg, jcfg, jparams, model = _models(arch, **replace)
    kw = dict(BASE, **kw)
    runs = {}
    for side in ("ref-host", "ref-jit", "host", "tick"):
        jitted = side.endswith(("jit", "tick"))
        if side.startswith("ref"):
            eng = jeng.Engine(jcfg, jparams,
                              jeng.EngineConfig(jitted=jitted, **kw))
        else:
            eng = teng.Engine(cfg, model, teng.EngineConfig(
                jitted=jitted, **kw), device="cpu")
        runs[side] = _workload(cfg.vocab_size, eng)
    return request.param, runs


@pytest.mark.parametrize("side", ["host", "tick"])
@pytest.mark.parametrize("ref", ["ref-host", "ref-jit"])
def test_engines_match_reference_engines(served, side, ref):
    """Tokens, stats and hit ratio of the port's run equal the
    reference's."""
    name, runs = served
    (tg, thr, tst), (jg, jhr, jst) = runs[side], runs[ref]
    assert sorted(tg) == sorted(jg) == list(range(8)), name
    assert tg == jg, name
    assert thr == jhr and tst == jst, name
    assert tst["prefix_hits"] > 0 and tst["decode_steps"] > 0


@pytest.mark.parametrize("name", ["sampled", "mixtral-fs2-sampled"])
def test_sampled_runs_differ_from_greedy(name):
    """A sampled case draws tokens that the argmax would not, from the
    same prefills (the first token of each request is the argmax)."""
    arch, replace, kw = CASES[name]
    cfg, _, _, model = _models(arch, **replace)
    runs = [_workload(cfg.vocab_size, teng.Engine(
        cfg, model, teng.EngineConfig(**BASE, **k), device="cpu"))[0]
        for k in (kw, {})]
    assert runs[0] != runs[1]
    assert all(runs[0][rid][0] == runs[1][rid][0] for rid in runs[0])
