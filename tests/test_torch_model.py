"""The port's model layers and LM against the reference (``repro.models``).

The same inputs and weights, made with numpy (or by the reference's own
``init_params`` and carried over by ``params_from_numpy``), go through both
packages on the CPU.  Float32 paths are held at 2e-5, bf16 paths at the
reference's bf16 tolerance, 3e-2 (``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.serve import paged_model as jpm
from repro_torch import configs
from repro_torch.models import layers as TL
from repro_torch.models import lm
from repro_torch.serve import paged_model as tpm

torch.set_num_threads(1)

BF = 3e-2
ARCHS = ["deepseek-7b", "gemma2-2b", "minicpm-2b"]


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_rms_norm_matches_reference():
    r = _rng(0)
    xj, xt = _bf16(r.standard_normal((3, 5, 64)).astype(np.float32) * 3)
    w = r.standard_normal(64).astype(np.float32) * 0.1
    got = TL.rms_norm(xt, torch.from_numpy(w), 1e-5)
    want = JL.rms_norm(xj, jnp.asarray(w), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)
    x32 = r.standard_normal((4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x32), torch.from_numpy(w[:32])).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x32), jnp.asarray(w[:32]))),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    r = _rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = r.integers(0, 900, (2, 7)).astype(np.int32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _attn_params(seed, d, h, kvh, hd):
    r = _rng(seed)
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
              "wo": (h * hd, d)}
    pj, pt = {}, {}
    for k, s in shapes.items():
        pj[k], pt[k] = _bf16(r.standard_normal(s).astype(np.float32)
                             * s[0] ** -0.5)
    return pj, pt


@pytest.mark.parametrize("window,softcap,q_chunk", [
    (0, 0.0, 2048), (5, 0.0, 2048), (0, 50.0, 2048), (6, 30.0, 4),
    (0, 0.0, 4)], ids=["causal", "window", "softcap", "window-softcap-chunked",
                       "chunked"])
def test_attention_matches_reference(window, softcap, q_chunk):
    """GQA prefill attention with sliding window, softcap and the q-chunk
    loop (S > 2 * q_chunk), bf16."""
    d, h, kvh, hd, s = 64, 4, 2, 16, 16
    pj, pt = _attn_params(2, d, h, kvh, hd)
    xj, xt = _bf16(_rng(3).standard_normal((2, s, d)).astype(np.float32))
    pos = np.arange(s, dtype=np.int32)[None]
    kw = dict(num_heads=h, num_kv_heads=kvh, head_dim=hd, softcap=softcap,
              window=window, q_chunk=q_chunk)
    got, (k, v) = TL.attention(pt, xt, torch.from_numpy(pos), **kw)
    want = JL.attention(pj, xj, jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)
    kj = JL.rope((xj @ pj["wk"]).reshape(2, s, kvh, hd), jnp.asarray(pos),
                 10000.0)
    np.testing.assert_allclose(_np(k), _np(kj), atol=BF, rtol=BF)
    np.testing.assert_allclose(
        _np(v), _np((xj @ pj["wv"]).reshape(2, s, kvh, hd)), atol=BF,
        rtol=BF)


def test_causal_mask_matches_reference():
    pq = np.arange(9, dtype=np.int32)[None]
    for w in (0, 1, 3):
        got = TL.causal_mask(torch.from_numpy(pq), torch.from_numpy(pq), w)
        want = JL.causal_mask(jnp.asarray(pq), jnp.asarray(pq), w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlp_and_project_kv_step_match_reference():
    r = _rng(4)
    d, f = 64, 128
    pj, pt = {}, {}
    for k, s in {"wi": (d, f), "wg": (d, f), "wo": (f, d)}.items():
        pj[k], pt[k] = _bf16(r.standard_normal(s).astype(np.float32)
                             * s[0] ** -0.5)
    xj, xt = _bf16(r.standard_normal((3, 1, d)).astype(np.float32))
    np.testing.assert_allclose(_np(TL.mlp(pt, xt)), _np(JL.mlp(pj, xj)),
                               atol=BF, rtol=BF)
    aj, at = _attn_params(5, d, 4, 2, 16)
    pos = np.array([0, 17, 300], np.int32)
    got = TL.project_kv_step(at, xt, torch.from_numpy(pos), num_kv_heads=2,
                             head_dim=16)
    want = JL.project_kv_step(aj, xj, jnp.asarray(pos), num_kv_heads=2,
                              head_dim=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BF, rtol=BF)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, reference cfg, reference params, port model) on the
    reference's own random weights."""
    cfg = configs.get(request.param).smoke
    jcfg = jconfigs.get(request.param).smoke
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    return cfg, jcfg, jparams, lm.params_from_numpy(cfg, tree, device="cpu")


def test_params_round_trip(arch):
    cfg, _, jparams, model = arch
    tree = lm.params_to_numpy(model)
    want = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        jparams)
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert model.embed.shape == (lm.padded_vocab(cfg), cfg.d_model)
    assert lm.layer_windows(cfg) == list(np.asarray(jlm.layer_windows(cfg)))


def test_prefill_logits_and_kv_match_reference(arch):
    """``prefill_padded`` on padded prompts: logits at length-1 and every
    layer's K/V over the real tokens.  The prompt is longer than
    gemma2-smoke's sliding window of 32."""
    cfg, jcfg, jparams, model = arch
    r = _rng(6)
    lengths = np.array([41, 9], np.int32)
    toks = np.zeros((2, 48), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = r.integers(2, cfg.vocab_size - 1, n)
    got = tpm.prefill_padded(cfg, model, torch.from_numpy(toks),
                             torch.from_numpy(lengths))
    want = jpm.prefill_padded(jcfg, jparams, jnp.asarray(toks),
                              jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=BF, rtol=BF)
    for i, n in enumerate(lengths):
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(_np(g[:, i, :n]), _np(w[:, i, :n]),
                                       atol=BF, rtol=BF)
    full = tpm.prefill_with_kv(cfg, model, torch.from_numpy(toks[:1, :41]))
    np.testing.assert_allclose(_np(full[0]), _np(got[0][:1]), atol=BF,
                               rtol=BF)


def test_dense_only():
    """Every family builds now (experts, SSM layers, an encoder), not the
    dense configs alone; the draw is the seed's, the same twice, with the
    reference's dtypes (bf16 weights, float32 norms, router and SSD
    scalars)."""
    for name, part in (("mixtral-8x22b", "moe"), ("hymba-1.5b", "ssm"),
                       ("seamless-m4t-large-v2", "cross")):
        model = lm.init_params(configs.get(name).smoke, device="cpu")
        assert getattr(model.blocks[0], part) is not None
    assert len(model.enc_blocks) == configs.get(name).smoke.enc_layers
    model = lm.init_params(configs.get("deepseek-7b").smoke, seed=3,
                           device="cpu")
    again = lm.init_params(configs.get("deepseek-7b").smoke, seed=3,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    moe = lm.init_params(configs.get("mixtral-8x22b").smoke, device="cpu")
    assert moe.blocks[0].moe["router"].dtype == torch.float32
    assert moe.blocks[0].moe["wi"].dtype == torch.bfloat16
