"""Every model family of the port's LM against the reference
(``repro.models.lm``) on the CPU, at each config's smoke size.

For each of the ten ``configs.ARCH_IDS``: the reference's own
``init_params`` carried over by ``params_from_numpy`` (and back, exactly);
``forward`` (with the VLM's ``prefix_embeds`` and the audio model's
``enc_embeds``) and three ``decode_step``s from ``init_cache``, logits
within the bf16 tolerance 3e-2 and greedy tokens equal (or a bf16 tie at
the first divergence).  The port's own prefill/decode consistency at 6e-2
as ``tests/test_archs_smoke.py`` checks the reference's, and for the
encoder-decoder with the cross caches filled from its encoder; the bf16
drift between the two paths per position equal to the reference's.  The paged
serving model with experts (mixtral, ``moe_ff_shards`` 2) and the hybrid
(hymba) against the reference's jitted ``prefill_padded`` /
``decode_paged``.  The reference runs jitted throughout (its layers run
compiled in any case, inside its ``lax.scan``).
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
from repro.serve import paged_model as jpm
from repro_torch import configs
from repro_torch.models import layers as TL
from repro_torch.models import lm
from repro_torch.serve import paged_model as tpm

torch.set_num_threads(1)

BF = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_PAIRS = {}


def _pair(arch, **replace):
    """(port cfg, reference cfg, reference params, port model) on the
    reference's random weights (its ``init_params`` run op by op, without
    compiling each config's whole init)."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _PAIRS:
        cfg = dataclasses.replace(configs.get(arch).smoke, **replace)
        jcfg = dataclasses.replace(jconfigs.get(arch).smoke, **replace)
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _PAIRS[key] = (cfg, jcfg, jparams,
                       lm.params_from_numpy(cfg, tree, device="cpu"))
    return _PAIRS[key]


_JITS = {}


def _jitted(fn, jcfg):
    """``jax.jit(partial(fn, jcfg))``, compiled once for the module."""
    if (fn, jcfg) not in _JITS:
        _JITS[fn, jcfg] = jax.jit(partial(fn, jcfg))
    return _JITS[fn, jcfg]


@pytest.fixture(scope="module", params=jconfigs.ARCH_IDS)
def family(request):
    return (request.param,) + _pair(request.param)


def _batch(cfg, b, s, seed):
    """Tokens and the frontend stubs of a [b, s] sequence, as the
    reference's smoke test makes them -> (tokens, reference kwargs, port
    kwargs)."""
    r = np.random.default_rng(seed)
    s_tok, jkw, tkw = s, {}, {}
    for name, on, length in (("prefix_embeds", cfg.frontend == "patch",
                              cfg.frontend_len),
                             ("enc_embeds", cfg.enc_layers > 0, s - s // 2)):
        if on:
            s_tok -= length
            e = jnp.asarray(r.standard_normal((b, length, cfg.d_model))
                            * 0.02, jnp.bfloat16)
            jkw[name] = e
            tkw[name] = torch.from_numpy(np.array(_np(e))).bfloat16()
    toks = r.integers(2, cfg.vocab_size, (b, s_tok)).astype(np.int32)
    return toks, jkw, tkw


def test_params_round_trip(family):
    """params_to_numpy(params_from_numpy(tree)) == tree, every leaf, with
    the reference's dtypes (float32 router, SSD scalars and norms)."""
    arch, cfg, _, jparams, model = family
    want = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        jparams)
    jax.tree.map(np.testing.assert_array_equal, lm.params_to_numpy(model),
                 want)
    for block in list(model.blocks) + list(model.enc_blocks):
        for name, part in ((n, getattr(block, n)) for n in lm.PARTS):
            for leaf, t in (part or {}).items():
                assert t.dtype == (torch.float32 if leaf in
                                   lm.F32_LEAVES.get(name, ())
                                   else torch.bfloat16), (arch, name, leaf)
    port_init = lm.init_params(cfg, seed=1, device="cpu")
    jax.tree.map(lambda a, b: a.shape == b.shape or pytest.fail(arch),
                 lm.params_to_numpy(port_init), want)


def _assert_greedy(arch, want_logits, got_logits, step):
    """Greedy tokens equal, or the two tokens tie within 3e-2 in the
    reference's logits."""
    w, g = want_logits.argmax(-1), got_logits.argmax(-1)
    for lane in np.flatnonzero(w != g):
        a, b = want_logits[lane, w[lane]], want_logits[lane, g[lane]]
        assert abs(a - b) <= BF + BF * abs(a), (arch, step, lane)


def test_forward_and_decode_match_reference(family):
    """``forward`` over 16 positions, then three ``decode_step``s fed the
    reference's greedy tokens: logits within 3e-2, bf16 like the
    reference's, greedy tokens equal or tied."""
    arch, cfg, jcfg, jparams, model = family
    b = 2
    toks, jkw, tkw = _batch(cfg, b, 16, seed=1)
    want = _jitted(jlm.forward, jcfg)(jparams, jnp.asarray(toks), **jkw)
    got = lm.forward(cfg, model, torch.from_numpy(toks), **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)
    _assert_greedy(arch, _np(want)[:, -1], _np(got)[:, -1], "forward")

    jcache = jlm.init_cache(jcfg, b, 32)
    tcache = lm.init_cache(cfg, b, 32, device="cpu")
    assert sorted(tcache) == sorted(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, (arch, k)
    tok = toks[:, 0]
    jstep = _jitted(jlm.decode_step, jcfg)
    for i in range(3):
        pos = np.full(b, i, np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(tok), jnp.asarray(pos),
                           jcache)
        tl, tcache = lm.decode_step(cfg, model, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=BF, rtol=BF)
        _assert_greedy(arch, _np(jl), _np(tl), i)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for k in jcache:
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]), atol=BF,
                                   rtol=BF, err_msg=f"{arch} cache {k}")


def _drift(full, dec):
    """Relative error of each position's decode logits against the
    forward's -> [B, S]."""
    return (np.linalg.norm(dec - full, axis=-1)
            / np.linalg.norm(full, axis=-1))


@pytest.mark.parametrize("arch", ["deepseek-7b", "mixtral-8x22b",
                                  "mamba2-130m", "hymba-1.5b"])
def test_bf16_drift_matches_reference(arch):
    """bf16 decoding parts from the teacher-forced forward by the
    reference's own amount: per position, the relative error of the
    decode's logits against the forward's is the reference's within 5 %
    (``chip_smoke.py`` holds the card's drift at full width to the same
    code's on the host CPU, whose numerics these are)."""
    cfg, jcfg, jparams, model = _pair(arch)
    b = 2
    toks, _, _ = _batch(cfg, b, 16, seed=1)
    jfull = _np(_jitted(jlm.forward, jcfg)(jparams, jnp.asarray(toks)))
    tfull = _np(lm.forward(cfg, model, torch.from_numpy(toks)))
    jcache = jlm.init_cache(jcfg, b, 32)
    tcache = lm.init_cache(cfg, b, 32, device="cpu")
    jstep = _jitted(jlm.decode_step, jcfg)
    jdec, tdec = [], []
    for i in range(toks.shape[1]):
        pos = np.full(b, i, np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, i]), jnp.asarray(pos),
                           jcache)
        tl, tcache = lm.decode_step(cfg, model, torch.from_numpy(toks[:, i]),
                                    torch.from_numpy(pos), tcache)
        jdec.append(_np(jl))
        tdec.append(_np(tl))
    want = _drift(jfull, np.stack(jdec, 1))
    np.testing.assert_allclose(_drift(tfull, np.stack(tdec, 1)), want,
                               rtol=5e-2, atol=1e-4)


def _fill_cross(cfg, model, enc_embeds, cache):
    """The encoder's output as every decoder layer's cross K/V."""
    enc = lm._encode(cfg, model, enc_embeds)
    t = enc.shape[1]
    for li, block in enumerate(model.blocks):
        k, v = TL.cross_kv(block.cross, enc, num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.hd)
        cache["cross_k"][li, :, :t] = k
        cache["cross_v"][li, :, :t] = v
    cache["cross_len"][:] = t


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-7b", "mamba2-130m",
                                  "hymba-1.5b", "seamless-m4t-large-v2"])
def test_prefill_decode_consistency(arch):
    """Decoding token by token equals the teacher-forced forward on the
    same tokens (6e-2, the reference's own check); the encoder-decoder
    with its encoder's K/V in the cross caches."""
    cfg = configs.get(arch).smoke
    model = lm.init_params(cfg, seed=2, device="cpu")
    b, s = 2, 8
    toks, _, tkw = _batch(cfg, b, 2 * s if cfg.enc_layers else s, seed=3)
    full = lm.forward(cfg, model, torch.from_numpy(toks), **tkw).float()
    cache = lm.init_cache(cfg, b, 16, device="cpu")
    if cfg.enc_layers:
        _fill_cross(cfg, model, tkw["enc_embeds"], cache)
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = lm.decode_step(
            cfg, model, torch.from_numpy(toks[:, i]),
            torch.full((b,), i, dtype=torch.int32), cache)
        outs.append(logits.float())
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                               atol=6e-2, rtol=6e-2)


@pytest.mark.parametrize("arch,replace", [
    ("mixtral-8x22b", dict(moe_ff_shards=2)), ("hymba-1.5b", {})],
    ids=["mixtral-fs2", "hymba"])
def test_paged_model_matches_reference(arch, replace):
    """The serving model: a padded prefill (MoE capacity over the padded
    width; hymba's SSD heads beside attention) and one paged decode step
    with an inactive lane (MoE in place of the MLP; hymba's attention
    alone, the reference's quirk), logits within 3e-2 and the pools'
    pages as the reference writes them."""
    cfg, jcfg, jparams, model = _pair(arch, **replace)
    r = np.random.default_rng(4)
    lengths = np.array([29, 11, 20], np.int32)
    toks = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = r.integers(2, cfg.vocab_size - 1, n)
    want = jpm.prefill_padded(jcfg, jparams, jnp.asarray(toks),
                              jnp.asarray(lengths))
    got = tpm.prefill_padded(cfg, model, torch.from_numpy(toks),
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=BF, rtol=BF)
    for i, n in enumerate(lengths):
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(_np(g[:, i, :n]), _np(w[:, i, :n]),
                                       atol=BF, rtol=BF)
    total, page = 16, 8
    shape = (cfg.num_layers, cfg.num_kv_heads, total, page, cfg.hd)
    pools = [jnp.asarray(r.standard_normal(shape), jnp.bfloat16)
             for _ in range(2)]
    tk, tv = (torch.from_numpy(np.array(_np(p))).bfloat16() for p in pools)
    pt = r.permutation(total)[:12].reshape(3, 4).astype(np.int32)
    pos = lengths.copy()
    active = np.array([True, False, True])
    tok = r.integers(2, cfg.vocab_size - 1, 3).astype(np.int32)
    jl, jk, jv = jpm.decode_paged(jcfg, jparams, jnp.asarray(tok),
                                  jnp.asarray(pos), *pools, jnp.asarray(pt),
                                  jnp.asarray(active))
    tl, _, _ = tpm.decode_paged(cfg, model, torch.from_numpy(tok),
                                torch.from_numpy(pos), tk, tv,
                                torch.from_numpy(pt),
                                torch.from_numpy(active))
    np.testing.assert_allclose(_np(tl)[active], _np(jl)[active], atol=BF,
                               rtol=BF)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=BF, rtol=BF)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=BF, rtol=BF)
