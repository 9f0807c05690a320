"""The port's paged serving path against the reference, on the CPU.

* ``serve.paged_model``: ``write_pages`` (skipped, invalid and repeated
  page ids) and ``decode_paged`` (inactive lanes) on the same pools and
  tables as ``repro.serve.paged_model``; pools agree bit for bit outside
  the slots a decode writes, logits at the bf16 tolerance 3e-2.
* ``serve.engine.Engine`` (host loop) against ``repro.serve.engine.Engine``
  (host loop, ``jnp`` backend) on the reference's own weights and the same
  prompts: equal stats, per-request pages and prefix hits; logits of every
  prefill and decode step within 3e-2; equal greedy tokens, except that
  where a token differs the reference's logits of the two tokens must tie
  within the tolerance (bf16), and that request's tokens are compared no
  further.
* The port's ``torch``, ``cuda`` (plain versions on CPU tensors) and
  ``ref`` prefix-cache backends give identical runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policies import Policy as JPolicy
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro.serve import paged_model as jpm
from repro_torch import configs
from repro_torch.core.policies import Policy
from repro_torch.models import lm
from repro_torch.serve import engine as teng
from repro_torch.serve import paged_model as tpm

torch.set_num_threads(1)

TOL = 3e-2
BASE = dict(page=8, num_sets=16, ways=4, max_batch=4, max_seq=128,
            private_pages=96)

_MODELS = {}


def _models(arch):
    """(port cfg, reference cfg, reference params, port model) on the
    reference's weights, built once per arch."""
    if arch not in _MODELS:
        cfg = configs.get(arch).smoke
        jcfg = jconfigs.get(arch).smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _MODELS[arch] = (cfg, jcfg, jparams,
                         lm.params_from_numpy(cfg, tree, device="cpu"))
    return _MODELS[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pools(seed, cfg, total, page):
    r = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, total, page, cfg.hd)
    a = r.standard_normal(shape).astype(np.float32)
    b = r.standard_normal(shape).astype(np.float32)
    j = (jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    t = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
              for x in j)
    return j, t


def test_write_pages_matches_reference():
    """Skipped (-1) and invalid lanes write nothing; a repeated page id
    keeps the last block, as the reference's scatter does; every other
    slot of the pools is untouched: bit for bit."""
    cfg, jcfg, _, _ = _models("deepseek-7b")
    page, total = 8, 12
    (jk, jv), (tk, tv) = _pools(0, cfg, total, page)
    r = np.random.default_rng(1)
    kv = r.standard_normal((2, cfg.num_layers, 2, 4 * page, cfg.num_kv_heads,
                            cfg.hd)).astype(np.float32)
    jkv = tuple(jnp.asarray(x, jnp.bfloat16) for x in kv)
    tkv = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                for x in jkv)
    slots = np.array([[3, -1, 7, 3], [5, 9, 0, 11]], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], bool)
    jk, jv = jpm.write_pages(jcfg, jkv, jnp.asarray(slots), jk, jv,
                             jnp.asarray(valid))
    tpm.write_pages(cfg, tkv, torch.from_numpy(slots), tk, tv,
                    torch.from_numpy(valid))
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-2b"])
def test_decode_paged_matches_reference(arch):
    """One decode step with an inactive lane: logits, and the pools bit for
    bit outside the slots the active lanes write (those at 3e-2)."""
    cfg, jcfg, jparams, model = _models(arch)
    page, total, pps = 8, 28, 6
    (jk, jv), (tk, tv) = _pools(2, cfg, total, page)
    r = np.random.default_rng(3)
    pt = r.permutation(total)[:4 * pps].reshape(4, pps).astype(np.int32)
    pos = np.array([13, 0, 40, 7], np.int32)
    active = np.array([True, False, True, True])
    tok = r.integers(2, cfg.vocab_size - 1, 4).astype(np.int32)
    jl, jk, jv = jpm.decode_paged(jcfg, jparams, *map(jnp.asarray, (
        tok, pos)), jk, jv, jnp.asarray(pt), jnp.asarray(active))
    tl, tk, tv = tpm.decode_paged(cfg, model, *map(torch.from_numpy, (
        tok, pos)), tk, tv, torch.from_numpy(pt), torch.from_numpy(active))
    np.testing.assert_allclose(_np(tl)[active], _np(jl)[active], atol=TOL,
                               rtol=TOL)
    written = np.zeros((total, page), bool)
    for i in np.flatnonzero(active):
        written[pt[i, pos[i] // page], pos[i] % page] = True
    for j, t in ((jk, tk), (jv, tv)):
        j, t = _np(j), _np(t)
        np.testing.assert_array_equal(t[:, :, ~written], j[:, :, ~written])
        np.testing.assert_allclose(t[:, :, written], j[:, :, written],
                                   atol=TOL, rtol=TOL)


def _prompts(seed, vocab, n, shared_len, tail=(1, 20)):
    r = np.random.default_rng(seed)
    shared = r.integers(2, vocab - 1, shared_len)
    return [np.concatenate([shared, r.integers(2, vocab - 1, int(k))])
            for k in r.integers(*tail, n)]


class _Spy:
    """Records the logits behind every sampled token, keyed by (request id,
    token index), by wrapping the module's prefill and sampler."""

    def __init__(self, mp, mod, engine_cls):
        self.logits = {}
        self.engine = None
        pf, sample, prefill = (mod.pm.prefill_padded, mod._sample_next,
                               engine_cls._prefill)
        last = {}

        def prefill_spy(*a, **k):
            out = pf(*a, **k)
            last["logits"] = _np(out[0][0])
            return out

        def sample_spy(*args):
            # the reference's sampler takes (ecfg, logits, step), the
            # port's (logits)
            lg = _np(args[1] if len(args) == 3 else args[0])
            if lg.ndim == 2:
                for i, r in enumerate(self.engine.slots):
                    if r is not None and not r.done:
                        self.logits[(r.rid, len(r.generated))] = lg[i]
            return sample(*args)

        def _prefill_spy(eng, req, slot):
            ok = prefill(eng, req, slot)
            if ok:
                self.logits[(req.rid, 0)] = last["logits"]
            return ok

        mp.setattr(mod.pm, "prefill_padded", prefill_spy)
        mp.setattr(mod, "_sample_next", sample_spy)
        mp.setattr(engine_cls, "_prefill", _prefill_spy)


def _serve(arch, side, kw, prompts, max_new, backend):
    cfg, jcfg, jparams, model = _models(arch)
    with pytest.MonkeyPatch.context() as mp:
        if side == "ref":
            spy = _Spy(mp, jeng, jeng.Engine)
            kw = dict(kw, policy=JPolicy[kw.get("policy", Policy.LRU).name])
            eng = jeng.Engine(jcfg, jparams,
                              jeng.EngineConfig(backend=backend, **kw))
        else:
            spy = _Spy(mp, teng, teng.Engine)
            eng = teng.Engine(cfg, model,
                              teng.EngineConfig(backend=backend, **kw),
                              device="cpu")
        spy.engine = eng
        for p in prompts:
            eng.submit(p, max_new=max_new)
        fin = eng.run()
    return eng.stats, fin, spy.logits


CASES = {
    "lru": ("deepseek-7b", {}, dict(seed=0, n=6, shared_len=32), 5),
    "tinylfu": ("deepseek-7b", dict(tinylfu=True),
                dict(seed=1, n=6, shared_len=24), 4),
    "pressure": ("deepseek-7b", dict(num_sets=4, ways=2),
                 dict(seed=2, n=6, shared_len=0, tail=(17, 40)), 3),
    "decode_block2-hyperbolic": (
        "minicpm-2b", dict(decode_block=2, policy=Policy.HYPERBOLIC),
        dict(seed=3, n=5, shared_len=16), 5),
    "out-of-pages": ("deepseek-7b", dict(private_pages=10, max_seq=64),
                     dict(seed=4, n=5, shared_len=16, tail=(3, 30)), 30),
    "gemma2-window": ("gemma2-2b", {}, dict(seed=5, n=4, shared_len=40), 4),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    arch, kw, pkw, max_new = CASES[request.param]
    cfg = configs.get(arch).smoke
    prompts = _prompts(vocab=cfg.vocab_size, **pkw)
    kw = dict(BASE, **kw)
    return (request.param, kw, prompts, max_new,
            _serve(arch, "ref", kw, prompts, max_new, "jnp"),
            _serve(arch, "port", kw, prompts, max_new, "torch"))


def test_engine_matches_reference(served):
    """Equal stats, pages and prefix hits; logits within 3e-2; tokens equal
    up to a bf16 tie at the first divergence."""
    name, _, prompts, _, (jst, jfin, jlog), (tst, tfin, tlog) = served
    assert tst == jst
    assert sorted(tfin) == sorted(jfin) == list(range(len(prompts)))
    for rid, jr in jfin.items():
        tr = tfin[rid]
        assert (tr.pages, tr.prefix_hits, tr.prefix_lookups, tr.pos) == \
            (jr.pages, jr.prefix_hits, jr.prefix_lookups, jr.pos), rid
        assert len(tr.generated) == len(jr.generated)
        for idx, (a, b) in enumerate(zip(jr.generated, tr.generated)):
            la, lb = jlog[(rid, idx)], tlog[(rid, idx)]
            np.testing.assert_allclose(lb, la, atol=TOL, rtol=TOL,
                                       err_msg=f"{name} rid {rid} tok {idx}")
            if a != b:
                assert abs(la[a] - la[b]) <= TOL + TOL * abs(la[a]), (
                    f"{name} rid {rid} tok {idx}: {a} vs {b} is no bf16 tie")
                break


def test_engine_cases_exercise_their_paths(served):
    name, kw, prompts, _, (jst, jfin, _), _ = served
    assert jst["decode_steps"] > 0 and jst["prefills"] >= len(prompts)
    if name == "pressure":
        assert jst["evictions"] > 0
    if name == "lru":
        assert jst["prefix_hits"] > 0
    if name == "out-of-pages":
        # the pool runs dry: admission backs off (prefills re-run the
        # prefix transaction) or a request finishes early
        assert jst["prefills"] > len(prompts) or any(
            len(r.generated) < 31 for r in jfin.values())


def test_port_backends_agree():
    """torch, cuda (plain versions on CPU tensors) and ref prefix-cache
    backends: identical stats, pages and tokens."""
    cfg = configs.get("deepseek-7b").smoke
    prompts = _prompts(7, cfg.vocab_size, 6, 24)
    kw = dict(BASE, num_sets=4, ways=4)
    runs = {}
    for backend in ("torch", "cuda", "ref"):
        st, fin, _ = _serve("deepseek-7b", "port", kw, prompts, 4, backend)
        runs[backend] = (st, {r: (q.generated, q.pages)
                              for r, q in fin.items()})
    assert runs["torch"] == runs["cuda"] == runs["ref"]
