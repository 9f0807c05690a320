"""The port's rematerialisation (``lm.remat_policy``, ``lm._call_block``)
against the reference's ``jax.checkpoint(body, policy=
dots_with_no_batch_dims_saveable)`` on the CPU, at each config's smoke size.

* What a checkpointed block holds for the backward equals the reference's
  residuals, in bytes per dtype: on the port, the storages its forward
  created that are still alive when it returns, less its output (the
  selective checkpoint's cache of the products' outputs; the block input
  and the parameters are not created there); on the reference, the
  non-argument entries of ``saved_residuals`` of its checkpointed block
  body, on the same numpy-seeded weights and inputs.  Every decoder block
  of the ten smoke configs and seamless's encoder block, at batch 2 and 1
  (at batch 1 an SSD chunk einsum reaches ``bmm`` with batch 1: still a
  batched product).  ``saved_tensors_hooks`` around the call sees only
  the block's inputs saved outside the checkpoint (its recompute reads
  them); without remat it sees every activation.
* The gradients with remat are bit-equal to those without, and the loss.
* One remat ``make_train_step`` step against the reference's jitted step,
  at ``tests/test_torch_train_step.py``'s tolerances.
"""
import dataclasses
import functools
import gc
import weakref
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

POLICY = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
STEP_TOL = 1e-3
GRAD_TOL = 3e-2
#: (batch, sequence) of the residual checks; the encoder reads 16 frames
SHAPES = ((2, 32), (1, 32))
ENC_T = 16
TRAIN_SHAPE = (2, 32)

_PAIRS = {}


def _pair(arch):
    """(port cfg, reference cfg, reference params, port model on them)."""
    if arch not in _PAIRS:
        jcfg = jconfigs.get(arch).smoke
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jax.device_get(jparams))
        cfg = configs.get(arch).smoke
        _PAIRS[arch] = (cfg, jcfg, jparams,
                        lm.params_from_numpy(cfg, tree, device="cpu"))
    return _PAIRS[arch]


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


# ---------------------------------------------------------------------------
# what a block holds for the backward
# ---------------------------------------------------------------------------

class _Created(TorchDispatchMode):
    """Every storage an op creates (a view creates none), by id, with a
    weak reference and its dtype."""

    def __init__(self):
        super().__init__()
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    st = o.untyped_storage()
                    self.storages[id(st)] = (weakref.ref(st), o.dtype)
        return out


def _port_held(fn, *args) -> tuple:
    """Run ``fn(*args)`` -> (bytes per dtype of the storages it created
    that are alive after it returned, less its output's; the tensors
    ``saved_tensors_hooks`` saw saved around the call)."""
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with saved_tensors_hooks(pack, lambda t: t), _Created() as created:
        out = fn(*args)
    gc.collect()
    held = Counter()
    own = out.untyped_storage()._cdata
    for ref, dtype in created.storages.values():
        st = ref()
        if st is not None and st._cdata != own:
            held[str(dtype).removeprefix("torch.")] += st.nbytes()
    return held, packed


def _ref_residuals(body, *args) -> Counter:
    """Bytes per dtype of the residuals ``jax.checkpoint`` keeps of
    ``body`` under the policy, less those that are its arguments."""
    out = Counter()
    for aval, where in saved_residuals(jax.checkpoint(body, policy=POLICY),
                                       *args):
        if not where.startswith("from the argument"):
            out[str(aval.dtype)] += aval.size * aval.dtype.itemsize
    return out


def _check_held(block, fn, args, want, label):
    got, packed = _port_held(
        lambda *a: lm._call_block(block, fn, True, *a), *args)
    assert got == want, (label, dict(got), dict(want))
    inputs = {a.untyped_storage()._cdata for a in args if a is not None}
    assert {t.untyped_storage()._cdata for t in packed} <= inputs, (
        label, "saved outside the checkpoint")
    full, saved = _port_held(
        lambda *a: lm._call_block(block, fn, False, *a), *args)
    assert saved and sum(full.values()) > sum(got.values()), label


@pytest.mark.parametrize("b,s", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_decoder_block_holds_the_reference_residuals(arch, b, s):
    """Each decoder block (every layer: gemma2's local and global) holds
    for the backward what the reference's checkpointed ``_block_seq``
    keeps: the outputs of its products without a batch dimension, but for
    the last projection that only the residual add reads."""
    cfg, jcfg, jparams, model = _pair(arch)
    model.requires_grad_(True)
    r = np.random.default_rng(5)
    xj, xt = _bf16(r.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    xt.requires_grad_(True)
    pos_j = jnp.arange(s, dtype=jnp.int32)[None]
    pos_t = torch.arange(s, dtype=torch.int32)[None]
    enc_j = enc_t = mask_j = mask_t = None
    if cfg.enc_layers:
        enc_j, enc_t = _bf16(r.standard_normal((b, ENC_T, cfg.d_model))
                             .astype(np.float32))
        enc_t.requires_grad_(True)
        mask_j = jnp.ones((1, s, ENC_T), jnp.bool_)
        mask_t = torch.ones((1, s, ENC_T), dtype=torch.bool)

    def body(x, p, positions, w, enc_out, enc_mask):
        return jlm._block_seq(jcfg, p, x, positions, w, enc_out, enc_mask)

    for li, (block, window) in enumerate(zip(model.blocks,
                                             lm.layer_windows(cfg))):
        p = jax.tree.map(lambda a: a[li], jparams["blocks"])
        want = _ref_residuals(body, xj, p, pos_j, jnp.int32(window), enc_j,
                              mask_j)

        def seq(x, positions, enc_out, enc_mask, block=block, window=window):
            return block.seq(cfg, x, positions, window, enc_out,
                             enc_mask)[0]

        _check_held(block, seq, (xt, pos_t, enc_t, mask_t), want,
                    (arch, li))


@pytest.mark.parametrize("b,s", SHAPES, ids=lambda v: str(v))
def test_encoder_block_holds_the_reference_residuals(b, s):
    """seamless's encoder block against the reference's checkpointed
    encoder body (``repro/models/lm.py`` ``_encode``, written inline
    there, so its lines are repeated here on the reference's layers)."""
    cfg, jcfg, jparams, model = _pair("seamless-m4t-large-v2")
    model.requires_grad_(True)
    r = np.random.default_rng(6)
    xj, xt = _bf16(r.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    xt.requires_grad_(True)
    pos_j = jnp.arange(s, dtype=jnp.int32)[None]
    full_j = jnp.ones((1, s, s), jnp.bool_)

    def body(carry, p, pos, full):
        h = jL.rms_norm(carry, p["ln1"], jcfg.norm_eps)
        a = jL.attention(p["attn"], h, pos, full,
                         num_heads=jcfg.num_heads,
                         num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.hd,
                         rope_theta=jcfg.rope_theta)
        x = carry + a
        h2 = jL.rms_norm(x, p["ln2"], jcfg.norm_eps)
        return x + jL.mlp(p["mlp"], h2)

    for li, block in enumerate(model.enc_blocks):
        p = jax.tree.map(lambda a: a[li], jparams["enc_blocks"])
        want = _ref_residuals(body, xj, p, pos_j, full_j)
        _check_held(block, functools.partial(block.encode, cfg),
                    (xt, torch.arange(s, dtype=torch.int32)[None],
                     torch.ones((1, s, s), dtype=torch.bool)), want,
                    ("encoder", li))


# ---------------------------------------------------------------------------
# values: remat changes none
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    """One [B, S] batch as the trainer feeds it, numpy-seeded -> (reference
    batch, port batch)."""
    b, s = TRAIN_SHAPE
    r = np.random.default_rng(seed)
    s_tok, stubs = s, {}
    if cfg.frontend == "patch":
        s_tok -= cfg.frontend_len
        stubs["prefix_embeds"] = (b, cfg.frontend_len)
    if cfg.enc_layers:
        s_tok = s // 2
        stubs["enc_embeds"] = (b, s - s_tok)
    jb, tb = {}, {}
    for k, shape in stubs.items():
        jb[k], tb[k] = _bf16(r.standard_normal((*shape, cfg.d_model)) * 0.02)
    for k, n in (("tokens", s_tok), ("labels", s)):
        a = r.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
        jb[k], tb[k] = jnp.asarray(a), torch.from_numpy(a)
    return jb, tb


@pytest.fixture
def entries(monkeypatch):
    """Counts the blocks that enter ``torch.utils.checkpoint``."""
    calls = []
    real = lm.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_remat_gradients_are_bit_equal(arch, entries):
    """The loss and every gradient with remat equal those without, bit
    for bit; remat checkpoints every decoder and encoder block, and
    ``remat=False`` none."""
    cfg = configs.get(arch).smoke
    _, tb = _batch(cfg, seed=11)
    runs = []
    for remat in (True, False):
        model = lm.init_params(cfg, seed=0, device="cpu")
        model.requires_grad_(True)
        del entries[:]
        loss = tstep.make_loss_fn(cfg, tstep.TrainConfig(remat=remat))(
            model, tb)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()},
                     len(entries)))
    (la, ga, na), (lb, gb, nb) = runs
    assert (na, nb) == (cfg.num_layers + cfg.enc_layers, 0), arch
    assert torch.equal(la, lb), arch
    for n in ga:
        assert (ga[n] is None) == (gb[n] is None), (arch, n)
        assert ga[n] is None or torch.equal(ga[n], gb[n]), (arch, n)


_STEPS = {}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_remat_train_step_matches_reference(arch, entries):
    """One ``make_train_step`` step (remat on by default, as in the
    reference) from the reference's weights against its jitted step: the
    loss within 1e-3 relative, the grad norm within 3e-2."""
    cfg, jcfg, jparams, _ = _pair(arch)
    ocfg = jadamw.AdamWConfig(lr=1e-3, total_steps=10)
    if jcfg not in _STEPS:
        _STEPS[jcfg] = jax.jit(jstep.make_train_step(
            jcfg, jstep.TrainConfig(optimizer=ocfg)))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    model = lm.params_from_numpy(cfg, tree, device="cpu")
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(
        **dataclasses.asdict(ocfg)))
    assert tcfg.remat
    jb, tb = _batch(cfg, seed=21)
    _, _, jm = _STEPS[jcfg](jparams, jadamw.init(jparams), jb)
    _, _, tm = tstep.make_train_step(cfg, tcfg)(model, adamw.init(model), tb)
    assert len(entries) == cfg.num_layers + cfg.enc_layers
    for k, tol in (("loss", STEP_TOL), ("grad_norm", GRAD_TOL)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                   err_msg=f"{arch} {k}")
