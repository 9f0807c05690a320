"""The port's MoE, Mamba2 SSD, decode and cross attention layers against
the reference (``repro.models.layers``) on the CPU.

The same numpy-seeded inputs and weights go through both packages.  The
reference runs each layer under ``jax.jit``, as it runs inside the model's
layer loop (XLA keeps a bf16 sum that is cast straight to float32 in
float32).  bf16 paths are held at the reference's bf16 tolerance 3e-2,
float32 paths (the SSD scan and step on float32 inputs and weights) at
2e-5 (``tests/test_kernels.py``); the MoE's drop sets exactly.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

torch.set_num_threads(1)

BF = 3e-2
F32 = 2e-5


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(r, d, ff, experts, fs, skew):
    ev, ffv = experts * fs, ff // fs
    router = (r.standard_normal((d, experts)) * d ** -0.5).astype(np.float32)
    router[:, 0] += skew
    pj, pt = {"router": jnp.asarray(router)}, {
        "router": torch.from_numpy(router)}
    for name, shape in (("wi", (ev, d, ffv)), ("wg", (ev, d, ffv)),
                        ("wo", (ev, ffv, d))):
        pj[name], pt[name] = _bf16(r.standard_normal(shape).astype(np.float32)
                                   * shape[1] ** -0.5)
    return pj, pt


def _ref_keep(pj, xj, experts, top_k, fs):
    """The reference's routing and drop decision, its own lines
    (``repro/models/layers.py`` ``moe``) on its own ops -> (virtual
    expert per pair, keep) as numpy."""
    b, s, _ = xj.shape
    gates = jax.nn.softmax(xj.astype(jnp.float32) @ pj["router"], axis=-1)
    _, idx = jax.lax.top_k(gates, top_k)
    if fs > 1:
        idx = (idx[..., None] * fs + jnp.arange(fs, dtype=idx.dtype)
               ).reshape(b, s, top_k * fs)
        top_k *= fs
    e = experts * fs
    cap = max(int(s * top_k * 1.25 / e), top_k)
    oh = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(b, s * top_k, e)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1)
    return np.asarray(idx), np.asarray(pos.reshape(b, s, top_k) < cap)


@pytest.mark.parametrize("fs,skew", [(1, 0.0), (2, 0.0), (1, 0.5),
                                     (2, 0.5)],
                         ids=["fs1", "fs2", "fs1-skewed", "fs2-skewed"])
def test_moe_matches_reference(fs, skew):
    """Routing, the (row, token, k) pairs dropped past each virtual
    expert's capacity, and the output.  The skewed router sends every
    token to expert 0 first (its inputs share a mean), so that expert
    overflows."""
    r = np.random.default_rng(10 + fs)
    d, ff, experts, top_k, b, s = 64, 128, 4, 2, 3, 16
    pj, pt = _moe_params(r, d, ff, experts, fs, skew)
    x = r.standard_normal((b, s, d)).astype(np.float32) + (skew > 0)
    xj, xt = _bf16(x)
    idx, keep = _ref_keep(pj, xj, experts, top_k, fs)
    tidx, _, _, tkeep, _ = TL.moe_route(pt, xt, num_experts=experts,
                                        top_k=top_k, ff_shards=fs)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if skew:
        assert (~keep).sum() >= b * (s - 10), "the skewed case drops pairs"
    want = jax.jit(partial(JL.moe, num_experts=experts, top_k=top_k,
                           ff_shards=fs))(pj, xj)
    got = TL.moe(pt, xt, num_experts=experts, top_k=top_k, ff_shards=fs)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)


@pytest.mark.parametrize("experts,top_k,skew", [(4, 2, 0.0), (8, 2, 0.0),
                                                (8, 1, 0.5)],
                         ids=["e4k2", "e8k2", "e8k1-skewed"])
def test_moe_aux_loss_matches_reference(experts, top_k, skew):
    """The load-balancing loss on the same float32 router and bf16 inputs
    at 2e-5 (float32 throughout); the skewed router sends most picks to
    expert 0, so the loss rises past its balanced value of 1."""
    r = np.random.default_rng(7)
    pj, pt = _moe_params(r, 64, 128, experts, 1, skew)
    xj, xt = _bf16(r.standard_normal((2, 16, 64)).astype(np.float32))
    want = float(JL.moe_aux_loss(pj, xj, num_experts=experts, top_k=top_k))
    got = TL.moe_aux_loss(pt, xt, num_experts=experts, top_k=top_k)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=F32)
    if skew:
        assert want > 1


def test_moe_shards_partition_the_expert():
    """``ff_shards`` splits each expert's d_ff exactly: two virtual
    experts' halves sum to the whole expert (no pair dropped)."""
    r = np.random.default_rng(3)
    d, ff, experts, b, s = 32, 64, 2, 2, 4
    pj, pt = _moe_params(r, d, ff, experts, 1, 0.0)
    halves = {k: v.reshape(experts, d, 2, ff // 2).permute(0, 2, 1, 3)
              .reshape(2 * experts, d, ff // 2) for k, v in pt.items()
              if k in ("wi", "wg")}
    halves["wo"] = pt["wo"].reshape(2 * experts, ff // 2, d)
    halves["router"] = pt["router"]
    _, xt = _bf16(r.standard_normal((b, s, d)).astype(np.float32))
    one = TL.moe(pt, xt, num_experts=experts, top_k=1, capacity_factor=4.0)
    two = TL.moe(halves, xt, num_experts=experts, top_k=1,
                 capacity_factor=4.0, ff_shards=2)
    np.testing.assert_allclose(_np(two), _np(one), atol=BF, rtol=BF)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

DIMS = JL.SSMDims.from_config(64, 16, 2, 16, 4)


def _ssm_params(seed, dtype):
    """The reference's ``init_ssm`` with random float32 scalars -> (jax,
    torch) params; ``dtype`` float32 makes every weight float32."""
    r = np.random.default_rng(seed)
    pj = dict(JL.init_ssm(jax.random.key(seed), DIMS))
    nh = DIMS.nheads
    pj["A_log"] = jnp.asarray(r.standard_normal(nh) * 0.5, jnp.float32)
    pj["dt_bias"] = jnp.asarray(r.standard_normal(nh) * 0.5, jnp.float32)
    pj["D"] = jnp.asarray(r.standard_normal(nh), jnp.float32)
    pj["norm"] = jnp.asarray(r.standard_normal(DIMS.d_inner) * 0.1,
                             jnp.float32)
    if dtype == "float32":
        pj = {k: v.astype(jnp.float32) for k, v in pj.items()}
    pt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in pj.items()}
    return pj, pt


def _inputs(seed, dtype, s=32):
    r = np.random.default_rng(seed)
    u = r.standard_normal((2, s, DIMS.d_model)).astype(np.float32)
    ssm = r.standard_normal((2, DIMS.nheads, DIMS.head_dim,
                             DIMS.state)).astype(np.float32)
    conv = r.standard_normal((2, DIMS.conv - 1, DIMS.d_inner
                              + 2 * DIMS.state)).astype(np.float32)
    if dtype == "float32":
        uj, ut = jnp.asarray(u), torch.from_numpy(u)
        cj, ct = jnp.asarray(conv), torch.from_numpy(conv)
    else:
        uj, ut = _bf16(u)
        cj, ct = _bf16(conv)
    return (uj, ut), ((jnp.asarray(ssm), cj), (torch.from_numpy(ssm), ct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True], ids=["zero-state",
                                                     "init-state"])
def test_ssd_scan_matches_reference(dtype, init):
    """Four chunks of 8 (the intra-chunk quadratic term and the
    inter-chunk recurrence), from zeros or from ``init_state``: y, the
    final SSM state and the conv state (the in-projection's last inputs),
    float32 at 2e-5, bf16 at 3e-2."""
    pj, pt = _ssm_params(1, dtype)
    (uj, ut), (sj, st) = _inputs(2, dtype)
    fn = jax.jit(lambda p, u, s0: JL.ssd_scan(p, u, DIMS, chunk=8,
                                              init_state=s0))
    yj, (ssj, ccj) = fn(pj, uj, sj if init else None)
    yt, (sst, cct) = TL.ssd_scan(pt, ut, DIMS, chunk=8,
                                 init_state=st if init else None)
    tol = F32 if dtype == "float32" else BF
    assert yt.dtype == ut.dtype and sst.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(sst), _np(ssj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(cct), _np(ccj), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_step_matches_reference(dtype):
    """Three recurrent steps from a random state: y and both states."""
    pj, pt = _ssm_params(3, dtype)
    (uj, ut), ((ssj, cj), (sst, ct)) = _inputs(4, dtype, s=3)
    fn = jax.jit(lambda p, u, st: JL.ssd_step(p, u, st, DIMS))
    tol = F32 if dtype == "float32" else BF
    for i in range(3):
        yj, (ssj, cj) = fn(pj, uj[:, i:i + 1], (ssj, cj))
        yt, (sst, ct) = TL.ssd_step(pt, ut[:, i:i + 1], (sst, ct), DIMS)
        np.testing.assert_allclose(_np(yt), _np(yj), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(sst), _np(ssj), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(ct), _np(cj), atol=tol, rtol=tol)


def test_ssd_scan_then_steps_continue_the_sequence():
    """A scan over 16 tokens then 4 steps equals one scan over 20 in its
    last 4 outputs (float32): the states hand over."""
    pj, pt = _ssm_params(5, "float32")
    (_, ut), _ = _inputs(6, "float32", s=20)
    whole, _ = TL.ssd_scan(pt, ut, DIMS, chunk=4)
    head, state = TL.ssd_scan(pt, ut[:, :16], DIMS, chunk=8)
    outs = []
    for i in range(16, 20):
        y, state = TL.ssd_step(pt, ut[:, i:i + 1], state, DIMS)
        outs.append(y)
    np.testing.assert_allclose(_np(torch.cat([head] + outs, 1)),
                               _np(whole), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# attention: decode, cross, encoder
# ---------------------------------------------------------------------------

def _attn_params(seed, d, h, kvh, hd):
    r = np.random.default_rng(seed)
    pj, pt = {}, {}
    for k, s in {"wq": (d, h * hd), "wk": (d, kvh * hd),
                 "wv": (d, kvh * hd), "wo": (h * hd, d)}.items():
        pj[k], pt[k] = _bf16(r.standard_normal(s).astype(np.float32)
                             * s[0] ** -0.5)
    return pj, pt


D, H, KVH, HD, T = 64, 4, 2, 16, 24


@pytest.mark.parametrize("case", ["cache-only", "kv-new", "window-softcap",
                                  "cross"])
def test_decode_attention_matches_reference(case):
    """One decode token per lane against a [B, T] cache: the cache alone,
    the two-part softmax with the token's own (k, v), a sliding window
    with a softcap, and cross attention over ``cross_len`` entries."""
    r = np.random.default_rng(7)
    pj, pt = _attn_params(8, D, H, KVH, HD)
    xj, xt = _bf16(r.standard_normal((3, 1, D)).astype(np.float32))
    kj, kt = _bf16(r.standard_normal((3, T, KVH, HD)).astype(np.float32))
    vj, vt = _bf16(r.standard_normal((3, T, KVH, HD)).astype(np.float32))
    pos = np.array([5, 0, 23], np.int32)
    kw = dict(num_heads=H, num_kv_heads=KVH, head_dim=HD)
    jkw, tkw = {}, {}
    if case == "window-softcap":
        kw.update(window=4, softcap=20.0)
    if case in ("kv-new", "window-softcap"):
        nk, nv = (_bf16(r.standard_normal((3, 1, KVH, HD)).astype(
            np.float32)) for _ in range(2))
        jkw["kv_new"], tkw["kv_new"] = (nk[0], nv[0]), (nk[1], nv[1])
    if case == "cross":
        cl = np.array([24, 7, 1], np.int32)
        jkw.update(is_cross=True, cross_len=jnp.asarray(cl))
        tkw.update(is_cross=True, cross_len=torch.from_numpy(cl))
    want = jax.jit(lambda p, x, ps, k, v: JL.decode_attention(
        p, x, ps, k, v, **kw, **jkw))(pj, xj, jnp.asarray(pos), kj, vj)
    got = TL.decode_attention(pt, xt, torch.from_numpy(pos), kt, vt, **kw,
                              **tkw)
    assert got.shape == (3, 1, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)


@pytest.mark.parametrize("case", ["cross", "encoder"])
def test_attention_with_kv_and_mask_matches_reference(case):
    """Cross attention over precomputed ``kv`` (``cross_kv``; no RoPE on
    q) under a mask, and encoder attention (roped, a full mask)."""
    r = np.random.default_rng(9)
    pj, pt = _attn_params(10, D, H, KVH, HD)
    s, t = 6, 10
    xj, xt = _bf16(r.standard_normal((2, s, D)).astype(np.float32))
    pos = np.arange(s, dtype=np.int32)[None]
    kw = dict(num_heads=H, num_kv_heads=KVH, head_dim=HD)
    if case == "cross":
        ej, et = _bf16(r.standard_normal((2, t, D)).astype(np.float32))
        kvj = JL.cross_kv(pj, ej, num_kv_heads=KVH, head_dim=HD)
        kvt = TL.cross_kv(pt, et, num_kv_heads=KVH, head_dim=HD)
        for a, b in zip(kvt, kvj):
            np.testing.assert_array_equal(_np(a), _np(b))
        mask = r.random((2, s, t)) < 0.7
        mask[..., 0] = True
        want = JL.attention(pj, xj, jnp.asarray(pos), jnp.asarray(mask),
                            kv=kvj, use_rope=False, **kw)
        got, _ = TL.attention(pt, xt, torch.from_numpy(pos),
                              torch.from_numpy(mask), kv=kvt,
                              use_rope=False, **kw)
    else:
        full = np.ones((1, s, s), bool)
        want = JL.attention(pj, xj, jnp.asarray(pos), jnp.asarray(full),
                            **kw)
        got, _ = TL.attention(pt, xt, torch.from_numpy(pos),
                              torch.from_numpy(full), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF, rtol=BF)
