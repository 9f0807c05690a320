"""The attention score temporaries of ``repro_torch.models.layers``: the
masked lanes filled with a scalar, and the softmax freed before its bf16
copy is widened, against plain versions of the same formulas kept here
(a ``full_like`` fill tensor for ``where``, out-of-place softcap, and the
q-chunk loop holding each chunk's weights until the next is made).

Outputs and gradients are bit-equal to the plain versions (bf16 and
float32 inputs, with and without a softcap, every decode case), and a
``StepCounter`` run of a q-chunked prefill holds two fewer score-sized
float32 storages at its peak.
"""
import pytest
import torch

from repro_torch.models import layers as TL
from repro_torch.roofline.analysis import StepCounter

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def plain_attn_weights(q, k, mask, scale, softcap):
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, TL.NEG_INF))
    return torch.softmax(logits, dim=-1)


def plain_weighted_values(w, v):
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float())


def plain_attention_core(q, k, v, positions, mask, *, causal_self, scale,
                         softcap, window, q_chunk):
    s = q.shape[1]
    if causal_self and q_chunk and s > 2 * q_chunk and s % q_chunk == 0:
        outs = []
        for c in range(s // q_chunk):
            sl = slice(c * q_chunk, (c + 1) * q_chunk)
            m = TL.causal_mask(positions[:, sl], positions, window=window)
            w = plain_attn_weights(q[:, sl], k, m, scale, softcap)
            outs.append(plain_weighted_values(w, v))
        return torch.cat(outs, dim=1)
    if mask is None:
        mask = TL.causal_mask(positions, positions, window=window)
    return plain_weighted_values(
        plain_attn_weights(q, k, mask, scale, softcap), v)


def plain_decode_core(q, pos, k_cache, v_cache, *, scale, softcap, window,
                      is_cross, cross_len, kv_new):
    t = k_cache.shape[1]
    kpos = torch.arange(t)[None, :]
    if is_cross:
        mask = (kpos < cross_len[:, None])[:, None, :]
    else:
        diff = pos.long()[:, None, None] - kpos[:, None, :]
        mask = diff >= 1
        if window > 0:
            mask = mask & (diff < window)
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k_cache.float()) * scale
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, TL.NEG_INF))
    if kv_new is None:
        return plain_weighted_values(torch.softmax(logits, dim=-1), v_cache)
    k_new, v_new = kv_new
    l_self = torch.einsum("bskgd,bskd->bkgs", q.float(),
                          k_new.float())[..., None] * scale
    if softcap > 0.0:
        l_self = torch.tanh(l_self / softcap) * softcap
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), l_self)
    w_c = torch.exp(logits - m)
    w_s = torch.exp(l_self - m)
    num = plain_weighted_values(w_c, v_cache)
    num = num + w_s.permute(0, 3, 1, 2, 4) * v_new.float()[:, :, :, None]
    den = w_c.sum(dim=-1, keepdim=True) + w_s
    return num / den.permute(0, 3, 1, 2, 4)


@pytest.fixture
def plain(monkeypatch):
    """Run ``layers`` with the plain versions in place of the new ones."""
    def use():
        monkeypatch.setattr(TL, "_attn_weights", plain_attn_weights)
        monkeypatch.setattr(TL, "_attention_core", plain_attention_core)
        monkeypatch.setattr(TL, "_decode_core", plain_decode_core)
    return use


def _params(g, d, h, kvh, hd, dtype):
    def w(*shape):
        return (torch.randn(*shape, generator=g) * shape[0] ** -0.5).to(dtype)
    return {"wq": w(d, h * hd), "wk": w(d, kvh * hd), "wv": w(d, kvh * hd),
            "wo": w(h * hd, d)}


def _leaves(p, *xs):
    return [t.detach().clone().requires_grad_(True)
            for t in list(p.values()) + list(xs)]


def _run(fn, leaves):
    out = fn(*leaves)
    out.float().square().sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _same(a, b):
    (oa, ga), (ob, gb) = a, b
    assert torch.equal(oa, ob)
    for x, y in zip(ga, gb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("softcap,window,q_chunk",
                         [(0.0, 0, 0), (30.0, 0, 0), (0.0, 5, 4),
                          (30.0, 3, 4)],
                         ids=["plain", "softcap", "chunked-window",
                              "chunked-softcap-window"])
def test_attention_bit_equal_to_plain_version(plain, dtype, softcap, window,
                                              q_chunk):
    """``attention`` (self, causal; q-chunked where ``q_chunk``): output
    and every gradient bit-equal to the plain versions'."""
    g = torch.Generator().manual_seed(7)
    d, h, kvh, hd = 32, 4, 2, 8
    p = _params(g, d, h, kvh, hd, dtype)
    x = torch.randn(2, 16, d, generator=g).to(dtype)
    pos = torch.arange(16)[None]

    def fn(wq, wk, wv, wo, x):
        return TL.attention({"wq": wq, "wk": wk, "wv": wv, "wo": wo}, x,
                            pos, num_heads=h, num_kv_heads=kvh,
                            head_dim=hd, softcap=softcap, window=window,
                            q_chunk=q_chunk)[0]

    new = _run(fn, _leaves(p, x))
    plain()
    _same(new, _run(fn, _leaves(p, x)))


@pytest.mark.parametrize("case", ["cache-only", "kv-new", "window-softcap",
                                  "cross"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decode_attention_bit_equal_to_plain_version(plain, case, dtype):
    """``decode_attention``: output and every gradient (weights, input,
    caches, the new token's K/V) bit-equal to the plain version's."""
    g = torch.Generator().manual_seed(11)
    d, h, kvh, hd, t = 32, 4, 2, 8, 12
    p = _params(g, d, h, kvh, hd, dtype)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    x, kc, vc = r(3, 1, d), r(3, t, kvh, hd), r(3, t, kvh, hd)
    kn, vn = r(3, 1, kvh, hd), r(3, 1, kvh, hd)
    pos = torch.tensor([4, 9, 12])
    kw = dict(num_heads=h, num_kv_heads=kvh, head_dim=hd)
    if case == "window-softcap":
        kw.update(window=4, softcap=20.0)
    if case == "cross":
        kw.update(is_cross=True, cross_len=torch.tensor([3, 12, 7]))

    def fn(wq, wk, wv, wo, x, kc, vc, kn, vn):
        return TL.decode_attention(
            {"wq": wq, "wk": wk, "wv": wv, "wo": wo}, x, pos, kc, vc,
            kv_new=None if case in ("cache-only", "cross") else (kn, vn),
            **kw)

    new = _run(fn, _leaves(p, x, kc, vc, kn, vn))
    plain()
    _same(new, _run(fn, _leaves(p, x, kc, vc, kn, vn)))


class _ScoreCounter(StepCounter):
    """``StepCounter`` that also counts the float32 storages of
    ``score_bytes`` alive when the live bytes reach their peak."""

    def __init__(self, score_bytes: int):
        super().__init__()
        self.score_bytes = score_bytes
        self.kind = {}
        self.at_peak = 0

    def _track(self, t, op=""):
        key = id(t.untyped_storage())
        if key not in self._refs:
            self.kind[key] = (t.dtype == torch.float32 and
                              t.untyped_storage().nbytes() == self.score_bytes)
        super()._track(t, op)
        if self.live == self.peak_new:
            self.at_peak = sum(1 for k in self._refs if self.kind.get(k))


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
def test_chunked_prefill_holds_two_fewer_scores(plain, softcap):
    """A q-chunked prefill (no graph), counted by ``StepCounter``: at the
    peak of live new storages two score-sized float32 tensors are alive,
    two fewer than under the plain versions (their scaled logits,
    ``full_like`` and ``where`` outputs alive together, with the last
    chunk's weights alive into the next chunk's); the new peak is inside
    the values product (its operand, the einsum's copy of it and the bf16
    weights), at least one score's bytes below the old; the output is the
    same."""
    g = torch.Generator().manual_seed(5)
    b, s, d, h, kvh, hd, qc = 2, 96, 32, 4, 2, 8, 32
    p = _params(g, d, h, kvh, hd, torch.bfloat16)
    x = torch.randn(b, s, d, generator=g).bfloat16()
    pos = torch.arange(s)[None]
    score = b * h * qc * s * 4

    def peak():
        counter = _ScoreCounter(score)
        counter.known(list(p.values()) + [x, pos])
        with torch.no_grad(), counter:
            out, _ = TL.attention(p, x, pos, num_heads=h, num_kv_heads=kvh,
                                  head_dim=hd, softcap=softcap, q_chunk=qc)
        return counter, out

    new, out = peak()
    plain()
    old, want = peak()
    assert torch.equal(out, want)
    assert (old.at_peak, new.at_peak) == (4, 2)
    assert old.peak_new - new.peak_new >= score
