"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``) on the CPU.

``schedule_fn`` (const, cosine, WSD) over steps 0 to twice
``total_steps`` at 1e-6 relative; ``init``; ``global_norm``; and three
successive ``update``s fed the *reference's own* gradients (Adam's first
step is close to sign(g), so feeding each side its own bf16 gradients
would amplify their rounding noise), the masters and moments at 2e-5
(float32; relative, and absolute against each leaf's largest value, since
a moment that cancels to near zero keeps only an absolute error), the
bf16 parameters equal except for one-ulp ties at a rounding boundary.
mamba2's ``ln2`` (no gradient: its block has no MLP) goes to
the port as None and to the reference as zeros.  ``state_from_numpy`` /
``state_to_numpy`` round-trip exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.optim import adamw

torch.set_num_threads(1)

F32_TOL = 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tensor(a) -> torch.Tensor:
    """A numpy or JAX array -> tensor of the same dtype (bf16 kept)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


SCHEDULES = [
    dict(schedule="const", lr=3e-3, warmup_steps=5, total_steps=40),
    dict(schedule="cosine", lr=3e-3, warmup_steps=5, total_steps=40),
    dict(schedule="cosine", lr=1e-3, warmup_steps=0, total_steps=7),
    dict(schedule="wsd", lr=1e-2, warmup_steps=4, total_steps=50),
    dict(schedule="wsd", lr=1e-2, warmup_steps=3, total_steps=13,
         decay_frac=0.3),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda k: "-".join(
    str(v) for v in k.values()))
def test_schedule_matches_reference(kw):
    jfn = jadamw.schedule_fn(jadamw.AdamWConfig(**kw))
    tfn = adamw.schedule_fn(adamw.AdamWConfig(**kw))
    steps = range(0, 2 * kw["total_steps"] + 1)
    want = np.array([float(jfn(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([float(tfn(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    assert tfn(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        adamw.schedule_fn(adamw.AdamWConfig(schedule="linear"))(
            torch.tensor(1))


_CASES = {}


def _case(arch):
    """(port cfg, reference params, three reference gradient trees)."""
    if arch not in _CASES:
        jcfg = jconfigs.get(arch).smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        vg = jax.jit(jax.grad(jstep.make_loss_fn(jcfg, jstep.TrainConfig())))
        r = np.random.default_rng(5)
        grads = []
        for _ in range(3):
            toks = jnp.asarray(r.integers(0, jcfg.vocab_size, (2, 16)),
                               jnp.int32)
            labels = jnp.asarray(r.integers(0, jcfg.vocab_size, (2, 16)),
                                 jnp.int32)
            batch = {"tokens": toks, "labels": labels}
            if jcfg.enc_layers:
                batch["enc_embeds"] = jnp.asarray(
                    r.standard_normal((2, 16, jcfg.d_model)) * 0.02,
                    jnp.bfloat16)
            grads.append(vg(jparams, batch))
        _CASES[arch] = (configs.get(arch).smoke, jparams, grads)
    return _CASES[arch]


def _model(cfg, jparams):
    return lm.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jax.device_get(jparams)), device="cpu")


def _port_grads(model, jgrads) -> dict:
    """The reference's gradient tree -> {name: tensor in the gradient's
    dtype}, None where the reference's gradient is all zeros."""
    out = {}
    for name, keys, i in lm.tree_paths(model):
        leaf = jgrads
        for k in keys:
            leaf = leaf[k]
        g = leaf if i is None else leaf[i]
        out[name] = None if not np.any(_np(g)) else _tensor(g)
    return out


def test_init_matches_reference():
    cfg, jparams, _ = _case("mamba2-130m")
    model = _model(cfg, jparams)
    state = adamw.init(model)
    want = jax.tree.map(np.asarray, jadamw.init(jparams))
    got = adamw.state_to_numpy(model, state)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert state["step"].dtype == torch.int32
    for name, p in model.named_parameters():
        assert state["master"][name].dtype == torch.float32
        # a real copy, float32 parameters (mamba2's A_log, D, norms) too
        assert state["master"][name].data_ptr() != p.data_ptr(), name


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_global_norm_matches_reference(arch):
    cfg, jparams, jgrads = _case(arch)
    model = _model(cfg, jparams)
    for g in jgrads:
        want = float(jadamw.global_norm(g))
        got = float(adamw.global_norm(_port_grads(model, g).values()))
        np.testing.assert_allclose(got, want, rtol=F32_TOL)


def _assert_bf16_ties(arch, step, got, want, masters):
    """bf16 parameters equal but for one-ulp ties: where they differ, each
    side is its own master rounded, and the two masters agree at 2e-5."""
    bits_g = got.astype(np.float32).view(np.int32)
    bits_w = want.astype(np.float32).view(np.int32)
    ulps = np.abs((bits_g >> 16) - (bits_w >> 16))
    assert ulps.max(initial=0) <= 1, (arch, step)
    assert (ulps > 0).mean() < 1e-3, (arch, step, (ulps > 0).mean())
    gm, wm = masters
    np.testing.assert_allclose(gm[ulps > 0], wm[ulps > 0], rtol=F32_TOL,
                               atol=F32_TOL * np.abs(wm).max())


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x22b",
                                  "mamba2-130m", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, total_steps=10),                           # the default
    dict(lr=3e-3, warmup_steps=1, total_steps=3, grad_clip=0.05),
    dict(lr=1e-2, warmup_steps=1, total_steps=4, schedule="wsd",
         decay_frac=0.5, weight_decay=0.0),
], ids=["default", "clipped", "wsd"])
def test_update_matches_reference(arch, kw):
    """Three updates on the reference's gradients: masters, moments, step,
    grad norm and lr at 2e-5; bf16 parameters equal but for ties."""
    cfg, jparams, jgrads = _case(arch)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    model = _model(cfg, jparams)
    state = adamw.init(model)
    p, jopt = jparams, jadamw.init(jparams)
    for step, g in enumerate(jgrads, start=1):
        p, jopt, jm = jadamw.update(jcfg, g, jopt, p)
        model, state, tm = adamw.update(tcfg, _port_grads(model, g), state,
                                        model)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=F32_TOL, err_msg=f"{arch} {k}")
        got = adamw.state_to_numpy(model, state)
        want = jax.tree.map(np.asarray, jopt)
        assert int(got["step"]) == int(want["step"]) == step
        for k in ("master", "m", "v"):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a, b, rtol=F32_TOL, atol=F32_TOL * np.abs(b).max(),
                err_msg=f"{arch} {k}"), got[k], want[k])
        wp = lm.from_tree(model, jax.tree.map(_np, p))
        gm = lm.from_tree(model, got["master"])
        wm = lm.from_tree(model, want["master"])
        for name, t in model.named_parameters():
            if t.dtype == torch.bfloat16:
                _assert_bf16_ties((arch, name), step, _np(t), wp[name],
                                  (gm[name], wm[name]))
            else:                      # a float32 parameter is its master
                np.testing.assert_array_equal(_np(t), gm[name])


def test_none_gradient_is_zero_gradient():
    """A parameter the loss did not reach (``.grad`` None) moves exactly as
    under a zero gradient: moments decay, weight decay applies."""
    cfg = configs.get("mamba2-130m").smoke
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    runs = []
    for zero in (False, True):
        model = lm.init_params(cfg, seed=3, device="cpu")
        with torch.no_grad():
            for blk in model.blocks:
                blk.ln2.fill_(0.5)
        state = adamw.init(model)
        grads = {n: (torch.full_like(p, 1e-3) if "ln2" not in n
                     else (torch.zeros_like(p) if zero else None))
                 for n, p in model.named_parameters()}
        adamw.update(ocfg, grads, state, model)
        runs.append(lm.params_to_numpy(model))
    jax.tree.map(np.testing.assert_array_equal, runs[0], runs[1])
    assert np.all(runs[0]["blocks"]["ln2"] < 0.5)        # decayed


def test_state_round_trips_exactly():
    """reference opt_state -> port -> numpy is the same tree, bit for bit,
    and port -> numpy -> port the same tensors."""
    cfg, jparams, jgrads = _case("mixtral-8x22b")
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    p, jopt = jparams, jadamw.init(jparams)
    p, jopt, _ = jadamw.update(jcfg, jgrads[0], jopt, p)
    want = jax.tree.map(np.asarray, jopt)
    model = _model(cfg, p)
    state = adamw.state_from_numpy(model, want)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    jax.tree.map(np.testing.assert_array_equal,
                 adamw.state_to_numpy(model, state), want)
    again = adamw.state_from_numpy(model, adamw.state_to_numpy(model, state))
    for k in ("master", "m", "v"):
        assert again[k].keys() == state[k].keys()
        for n in state[k]:
            assert torch.equal(again[k][n], state[k][n]), (k, n)


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(adamw.AdamWConfig)] == \
        [f.name for f in dataclasses.fields(jadamw.AdamWConfig)]
    assert dataclasses.asdict(adamw.AdamWConfig()) == \
        dataclasses.asdict(jadamw.AdamWConfig())
