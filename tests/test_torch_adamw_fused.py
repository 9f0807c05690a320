"""The optimizer's two ops (``repro_torch.kernels.adamw``: ``adamw_sumsq``
and ``adamw_step_``) on the CPU, where they run their plain versions.

``adamw.update`` (one call of each op over every leaf) against the
reference's ``update`` (``repro/optim/adamw.py:80``) over three steps on
four smoke archs, the clip active and inactive (scale exactly 1.0), with
one microbatch (the gradients in the parameters' dtypes) and two (float32
sums), one leaf's gradient None (zeros on the reference's side), at
``test_torch_adamw.py``'s ``F32_TOL``; ``torch.library.opcheck`` of both
ops; under ``FakeTensorMode`` the ops allocate only the norm's 0-d result
and ``StepCounter`` counts ``chip_smoke.optimizer_bytes``' bytes for
them; the leaf table's rows and a model of the kernels' chunk walk.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.kernels import adamw as kadamw
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roof
from test_torch_adamw import (F32_TOL, _assert_bf16_ties, _case, _model, _np,
                              _port_grads)

torch.set_num_threads(1)

ARCHS = ["gemma2-2b", "mixtral-8x22b", "mamba2-130m",
         "seamless-m4t-large-v2"]
CLIPS = {"inactive": 1e6, "active": 0.05}


def _with_zero_leaf(model, jgrads):
    """The reference's gradient tree with the model's first leaf zeroed
    (the port's ``_port_grads`` turns it into None)."""
    tree = jax.tree.map(np.array, jax.device_get(jgrads))
    _, keys, i = next(iter(lm.tree_paths(model)))
    leaf = tree
    for k in keys[:-1]:
        leaf = leaf[k]
    if i is None:
        leaf[keys[-1]] = np.zeros_like(leaf[keys[-1]])
    else:
        leaf[keys[-1]][i] = 0
    return tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("grad_dtype", ["param", "float32"],
                         ids=["one_microbatch", "two_microbatches"])
def test_update_matches_reference(arch, clip, grad_dtype):
    """Three ``adamw.update`` steps on the reference's gradients: the norm,
    masters and moments at F32_TOL, bf16 parameters equal but for ties, a
    float32 parameter equal to its master; with the clip inactive the
    scale is exactly 1.0."""
    cfg, jparams, jgrads = _case(arch)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=4,
              grad_clip=CLIPS[clip])
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    model = _model(cfg, jparams)
    state = adamw.init(model)
    p, jopt = jparams, jadamw.init(jparams)
    launches = dict(kadamw.LAUNCHES)
    for step, g in enumerate(jgrads, start=1):
        g = _with_zero_leaf(model, g)
        if grad_dtype == "float32":
            g = jax.tree.map(lambda a: np.asarray(a, np.float32), g)
        p, jopt, jm = jadamw.update(jcfg, g, jopt, p)
        grads = _port_grads(model, g)
        assert grads[next(iter(grads))] is None
        model, state, tm = adamw.update(tcfg, grads, state, model)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=F32_TOL, err_msg=f"{arch} {k}")
        if clip == "inactive":
            assert float(tm["grad_norm"]) < CLIPS[clip]
        else:
            assert float(tm["grad_norm"]) > CLIPS[clip]
        got = adamw.state_to_numpy(model, state)
        want = jax.tree.map(np.asarray, jopt)
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
            else:
                np.testing.assert_array_equal(_np(t), gm[name])
    # the CPU runs the plain versions: no kernel launched
    assert kadamw.LAUNCHES == launches


def _leaves(seed=0):
    """Odd, zero-size and mixed-dtype leaves: (grads, m, v, master,
    params); one gradient None, one parameter None."""
    rng = np.random.default_rng(seed)
    sizes = [1, 3, 4, 1027, 0, 16384 + 5, 33]
    gdt = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32,
           torch.bfloat16, torch.bfloat16, None]
    pdt = [torch.bfloat16, torch.float32, None, torch.bfloat16,
           torch.bfloat16, torch.float32, torch.bfloat16]

    def f32(n, s=1.0):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32) * s)

    grads = [None if d is None else f32(n, 1e-2).to(d)
             for n, d in zip(sizes, gdt)]
    m = [f32(n, 1e-3) for n in sizes]
    v = [f32(n, 1e-3).abs() for n in sizes]
    master = [f32(n) for n in sizes]
    params = [None if d is None else w.to(d) for w, d in zip(master, pdt)]
    return grads, m, v, master, params


def _scalars(scale=1.0):
    return [torch.tensor(x, dtype=torch.float32)
            for x in (scale, 3e-3, 0.1, 0.05)]


def test_opcheck():
    """Both ops' schema, fake and dispatch registrations.  Every parameter
    is present here: torch's auto-functionalization (torch.compile's path,
    which the port never takes) fails on a None inside a mutated list;
    the None parameter runs in ``test_step_is_the_plain_version``."""
    grads, m, v, master, params = _leaves()
    params = [w.clone() if p is None else p for p, w in zip(params, master)]
    torch.library.opcheck(torch.ops.repro_torch.adamw_step_.default,
                          (grads, m, v, master, params, *_scalars(0.7), 0.9,
                           0.95, 1e-8, 0.1))
    torch.library.opcheck(torch.ops.repro_torch.adamw_sumsq.default,
                          ([g for g in grads if g is not None],))


def test_step_is_the_plain_version():
    """On CPU tensors the op is its plain version, bit for bit."""
    a, b = _leaves(), _leaves()
    kadamw.adamw_step_(*a, *_scalars(0.7), 0.9, 0.95, 1e-8, 0.1)
    kadamw.adamw_step_plain(*b, *_scalars(0.7), 0.9, 0.95, 1e-8, 0.1)
    for xs, ys in zip(a[1:], b[1:]):
        for x, y in zip(xs, ys):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
    grads = [g for g in _leaves()[0] if g is not None]
    assert torch.equal(kadamw.sumsq(grads), kadamw.sumsq_plain(grads))


def test_fake_ops_allocate_nothing_and_count_the_kernels_bytes():
    """Under FakeTensorMode the two passes over a model's leaves create
    only the norm's 4 bytes, and StepCounter counts what the kernels move:
    ``optimizer_bytes`` (each gradient read twice, master, m and v read
    and written, the parameter written) plus the five float32 scalars;
    ``adamw.update`` as a whole creates no leaf-sized temporary."""
    cfg = configs.get("gemma2-2b").smoke
    with FakeTensorMode():
        model = configs.param_specs(cfg, device="cpu")
        state = adamw.init(model)
        params = dict(model.named_parameters())
        grads = {n: torch.empty_like(p) for n, p in params.items()}
        leaves = [(grads[n], state["m"][n], state["v"][n],
                   state["master"][n], p) for n, p in params.items()]
        scalars = _scalars()
        counter = roof.StepCounter()
        counter.known([t for leaf in leaves for t in leaf] + scalars)
        with counter:
            kadamw.sumsq([g for g, *_ in leaves])
            kadamw.adamw_step_(*map(list, zip(*leaves)), *scalars, 0.9,
                               0.95, 1e-8, 0.1)
        assert counter.ops == 2
        assert counter.peak_new == 4
        assert counter.bytes == chip_smoke.optimizer_bytes(model) + 5 * 4
        whole = roof.StepCounter()
        whole.known(list(params.values()) + list(grads.values())
                    + [t for k in ("m", "v", "master")
                       for t in state[k].values()] + [state["step"]])
        with whole:
            adamw.update(adamw.AdamWConfig(), grads, state, model)
        smallest = min(p.numel() * 4 for p in params.values())
        assert whole.peak_new < smallest, whole.peak_new


def test_table_rows_cover_every_element_once():
    """The leaf table's rows, and a model of the kernels' walk (a fixed
    grid striding over the chunks, each chunk's leaf by binary search of
    the first chunks): every element of every leaf of nonzero size is
    visited exactly once; zero-size leaves have no row; the flags carry
    both dtypes (0 where absent) and the alignment."""
    grads, m, v, master, params = _leaves()
    leaves = list(zip(grads, m, v, master, params))
    addr = {}

    def ptr(t):      # 16-byte aligned except the fourth leaf's gradient
        if id(t) not in addr:
            addr[id(t)] = 4096 * (len(addr) + 1) + (8 if t is grads[3]
                                                   else 0)
        return addr[id(t)]

    rows, chunks = kadamw.table_rows(leaves, ptr)
    table = np.array(rows, np.int64).reshape(-1, 8)
    live = [leaf for leaf in leaves if leaf[3].numel()]
    assert len(table) == len(live) == len(leaves) - 1
    for row, (g, _, _, w, p) in zip(table, live):
        assert row[5] == w.numel()
        assert row[7] & 0xFF == (0 if g is None else kadamw._DTYPES[g.dtype])
        assert row[7] >> 8 & 0xFF == (0 if p is None
                                      else kadamw._DTYPES[p.dtype])
        assert (row[0] == 0) == (g is None) and (row[4] == 0) == (p is None)
        assert row[7] >> 16 == int(g is not grads[3])
    assert chunks == sum(-(-w.numel() // kadamw.CHUNK) for *_, w, _ in live)
    seen = [np.zeros(w.numel(), np.int64) for *_, w, _ in live]
    chunk0 = table[:, 6]
    for grid in (1, 3, 528):
        for s in seen:
            s[:] = 0
        for block in range(grid):
            for c in range(block, chunks, grid):
                leaf = int(np.searchsorted(chunk0, c, side="right")) - 1
                off = (c - chunk0[leaf]) * kadamw.CHUNK
                seen[leaf][off: off + kadamw.CHUNK] += 1
        assert all((s == 1).all() for s in seen)
