"""The port's loss, gradients and train step against the reference
(``repro.train.step``) on the CPU, at each config's smoke size.

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same batches (a numpy seed; the VLM's
``prefix_embeds`` and the audio model's ``enc_embeds`` as random bf16
stubs) go through both.  ``cross_entropy`` on the same logits (a padded
vocab, ``z_loss`` > 0) at 2e-5; ``make_loss_fn``'s loss within 1e-4
relative and every leaf of ``grads_to_numpy`` within 3e-2 relative L2 of
``jax.value_and_grad`` on all ten configs; ``make_train_step`` for 3 steps
with ``microbatches`` 1 and 2, each step's loss within 1e-3 relative of the
reference's jitted step; ``make_eval_step`` within 1e-4.  Serving stays
graph-free: ``lm.forward`` on a serving model and the engine's outputs do
not require grad, and never enter the remat checkpoint.  The reference runs jitted, compiled once per config for
the module.
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
from repro_torch.train import step as tstep

torch.set_num_threads(1)

LOSS_TOL = 1e-4
GRAD_TOL = 3e-2
STEP_TOL = 1e-3
B, S = 2, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_PAIRS = {}


def _pair(arch):
    """(port cfg, reference cfg, reference params, its numpy tree) on the
    reference's random weights."""
    if arch not in _PAIRS:
        jcfg = jconfigs.get(arch).smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        _PAIRS[arch] = (configs.get(arch).smoke, jcfg, jparams, tree)
    return _PAIRS[arch]


def _batches(cfg, n, seed):
    """``n`` batches [B, S] as the reference's smoke test makes them ->
    [(reference batch, port batch)]."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s_tok, stubs = S, {}
        if cfg.frontend == "patch":
            s_tok -= cfg.frontend_len
            stubs["prefix_embeds"] = (B, cfg.frontend_len)
        if cfg.enc_layers:
            s_tok = S // 2
            stubs["enc_embeds"] = (B, S - s_tok)
        arrays = {k: jnp.asarray(r.standard_normal((*shape, cfg.d_model))
                                 * 0.02, jnp.bfloat16)
                  for k, shape in stubs.items()}
        arrays["tokens"] = r.integers(0, cfg.vocab_size, (B, s_tok)).astype(
            np.int32)
        arrays["labels"] = r.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        tb = {k: torch.from_numpy(np.array(_np(v))).bfloat16()
              if k.endswith("embeds") else torch.from_numpy(v)
              for k, v in arrays.items()}
        out.append((jb, tb))
    return out


def _rel_l2(got, want) -> float:
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    return num if den == 0 else num / den


def _assert_grads(arch, got_tree, want_tree):
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want], arch
    for (path, g), (_, w) in zip(got, want):
        w = _np(w)
        assert g.shape == w.shape, (arch, path)
        err = _rel_l2(g, w)
        assert err <= GRAD_TOL, (arch, jax.tree_util.keystr(path), err)


def test_cross_entropy_matches_reference():
    """Padded vocab masked at -1e30, ``z_loss`` > 0: the same logits give
    the same loss at 2e-5."""
    cfg = configs.get("gemma2-2b").smoke
    jcfg = jconfigs.get("gemma2-2b").smoke
    r = np.random.default_rng(3)
    vp = lm.padded_vocab(cfg) + 256          # lanes past the vocab too
    logits = (r.standard_normal((B, S, vp)) * 4).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits_bf = jnp.asarray(logits, jnp.bfloat16)
    for z in (0.0, 1e-2):
        want = float(jstep.cross_entropy(jcfg, logits_bf, jnp.asarray(labels),
                                         z))
        got = float(tstep.cross_entropy(
            cfg, torch.from_numpy(np.array(_np(logits_bf))).bfloat16(),
            torch.from_numpy(labels), z))
        np.testing.assert_allclose(got, want, rtol=2e-5)


_VG = {}


def _ref_value_and_grad(jcfg):
    if jcfg not in _VG:
        _VG[jcfg] = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jcfg, jstep.TrainConfig())))
    return _VG[jcfg]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_match_value_and_grad(arch):
    """``make_loss_fn`` + backward against ``jax.value_and_grad``: loss
    within 1e-4 relative, every gradient leaf (``grads_to_numpy``, zeros
    where the loss does not reach) within 3e-2 relative L2."""
    cfg, jcfg, jparams, tree = _pair(arch)
    (jb, tb), = _batches(cfg, 1, seed=11)
    want_loss, want_grads = _ref_value_and_grad(jcfg)(jparams, jb)
    model = lm.params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    loss = tstep.make_loss_fn(cfg, tstep.TrainConfig())(model, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_TOL)
    _assert_grads(arch, lm.grads_to_numpy(model), want_grads)


_STEPS = {}


def _ref_train_step(jcfg, tcfg):
    if (jcfg, tcfg) not in _STEPS:
        _STEPS[jcfg, tcfg] = jax.jit(jstep.make_train_step(jcfg, tcfg))
    return _STEPS[jcfg, tcfg]


TRAIN_CASES = ([(a, 1) for a in jconfigs.ARCH_IDS]
               + [(a, 2) for a in ("gemma2-2b", "mixtral-8x22b",
                                   "mamba2-130m", "seamless-m4t-large-v2")])


@pytest.mark.parametrize("arch,microbatches", TRAIN_CASES)
def test_train_step_losses_match_reference(arch, microbatches):
    """Three ``make_train_step`` steps from the same weights and batches:
    each step's loss within 1e-3 relative of the reference's jitted step;
    the grad norm and the learning rate too; the bf16 parameters move."""
    cfg, jcfg, jparams, tree = _pair(arch)
    ocfg = jadamw.AdamWConfig(lr=1e-3, total_steps=10)
    jt = jstep.TrainConfig(optimizer=ocfg, microbatches=microbatches)
    tt = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **dataclasses.asdict(ocfg)), microbatches=microbatches)
    jfn = _ref_train_step(jcfg, jt)
    model = lm.params_from_numpy(cfg, tree, device="cpu")
    before = lm.params_to_numpy(model)
    state = adamw.init(model)
    jopt = jadamw.init(jparams)
    tfn = tstep.make_train_step(cfg, tt)
    p = jparams
    for i, (jb, tb) in enumerate(_batches(cfg, 3, seed=21)):
        p, jopt, jm = jfn(p, jopt, jb)
        model, state, tm = tfn(model, state, tb)
        for k, tol in (("loss", STEP_TOL), ("grad_norm", GRAD_TOL),
                       ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"{arch} step {i} {k}")
    assert int(state["step"]) == 3
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.any(a != b)), lm.params_to_numpy(model), before))
    assert any(moved), arch


@pytest.mark.parametrize("arch", ["gemma2-2b", "seamless-m4t-large-v2"])
def test_eval_step_matches_reference(arch):
    cfg, jcfg, jparams, tree = _pair(arch)
    (jb, tb), = _batches(cfg, 1, seed=31)
    want = float(jax.jit(jstep.make_eval_step(jcfg))(jparams, jb))
    model = lm.params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    got = tstep.make_eval_step(cfg)(model, tb)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=LOSS_TOL)


def _tensors(obj):
    """Every tensor an engine holds: its attributes, and the fields of the
    dataclasses among them (the tick's ``ServeState``)."""
    for v in vars(obj).values():
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            yield from _tensors(v)


def test_serving_stays_graph_free(monkeypatch):
    """A serving model's weights are frozen: ``lm.forward`` on it and the
    engine (host loop and tick) hold no tensor that requires grad and
    never enter the remat checkpoint, nor does a forward under
    ``torch.no_grad()``, while a model the trainer unfroze builds a graph
    through one checkpoint a block."""
    from repro_torch.serve.engine import Engine, EngineConfig
    entered = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: (
        entered.append(fn), real(fn, *a, **kw))[1])
    cfg = configs.get("deepseek-7b").smoke
    model = lm.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits = lm.forward(cfg, model, toks)
    assert not logits.requires_grad and logits.grad_fn is None
    for jitted in (False, True):
        eng = Engine(cfg, model, EngineConfig(
            page=8, num_sets=8, ways=4, max_batch=2, max_seq=64,
            private_pages=32, jitted=jitted), device="cpu")
        for row in toks.numpy():
            eng.submit(row, max_new=3)
        fin = eng.run()
        assert len(fin) == 2 and all(r.done for r in fin.values())
        held = list(_tensors(eng))
        assert held and not any(t.requires_grad for t in held), jitted
    trained = lm.init_params(cfg, seed=1, device="cpu")
    trained.requires_grad_(True)
    with torch.no_grad():
        assert not lm.forward(cfg, trained, toks).requires_grad
    assert not entered
    out = lm.forward(cfg, trained, toks)
    assert out.requires_grad and len(entered) == cfg.num_layers
    out.float().sum().backward()
    assert trained.embed.grad is not None
    assert not any(p.requires_grad for p in model.parameters())
