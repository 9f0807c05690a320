"""Mesh execution on 4 CPU processes (``gloo``): the set-sharded cache
one shard a process, the trainer on a 2x2 (data, model) mesh, and the
elastic restore of an unsharded checkpoint onto that mesh.

One spawned group of 4 ranks runs every check (``_worker``) and rank 0
writes what it saw; the module's tests read it against what this process
computes without a mesh:

* ``ShardedCache(cfg, mesh)`` with D = 4 equals the reference's sharded
  cache (``repro.core.sharded``) on every lane, chunk by chunk: LRU, and
  TinyLFU with a sketch per shard; LRU also equals the unsharded
  reference in hits, evictions and final keys / vals;
* ``CommDebugMode`` counts no collective inside a shard's own access and
  one all-gather per ``access`` call;
* ``launch.train.run`` with ``--data 2 --model 2`` on a widened smoke
  config (its vocabulary and heads split over the model axis), every
  block rematerialised, gives losses within 1e-3 relative of the
  one-device run;
* on the same 2x2 mesh the vocabulary-parallel loss equals one device's
  (loss and logits gradient within 1e-6), with three all-reduces in its
  forward, none in its backward, and no rank creating the global
  [rows, S, padded vocab] tensor; attention on head shards equals the
  plain call within 2e-5 (float32), and a layer whose heads the axis does
  not divide takes the batch-only path;
* on a 1x4 mesh over the same ranks, attention and decode attention in
  gcd(H, 4) head groups (6 / 6 and 6 / 2 heads: 3 a rank; 6 / 3 keeps
  all 6, as the reference's HLO does) and a Mamba2 block on its SSD heads
  (6 heads: 2, 2, 2 and none) equal the plain call within 2e-5, output
  and every gradient;
* a checkpoint saved by the one-device trainer restores onto the 2x2
  mesh with equal values (the counterpart of
  ``tests/test_ckpt_data.py::test_elastic_restore_to_different_mesh``).
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core.kway import KWayConfig as JConfig
from repro.core.policies import Policy as JPolicy
from repro.core.sharded import ShardedCache as JSharded
from repro.core.sharded import ShardedConfig as JShardedConfig
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.roofline.analysis import StepCounter

WORLD = 4
SETS, WAYS, CHUNK, CHUNKS = 64, 4, 64, 8
TL = dict(width=64, door_bits=128, sample=200)
ARCH = "gemma2-2b"
#: lr 1e-3, as the card-vs-CPU training checks use: the weights are bf16,
#: so a sum taken in another order can round a weight to its neighbour,
#: and Adam's first steps (about lr x sign(g)) carry such flips into the
#: loss; at the launcher's 3e-3 the third loss parts by 1.1e-3
TRAIN = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32",
         "--steps", "3", "--lr", "1e-3", "--device", "cpu"]
LEAVES = ("keys", "fprint", "vals", "meta_a", "meta_b", "clock")


def widened():
    """gemma2-2b's smoke config widened so that stacked leaves of the
    embedding, the MLP and the attention pass the 1 Mi-element threshold:
    the model axis splits the vocabulary and the heads (4 query and 2 KV
    heads of gemma2's 256 lanes)."""
    return dataclasses.replace(configs.get(ARCH).smoke, d_model=512,
                               d_ff=2048, vocab_size=4000, head_dim=256)


def _use_widened():
    spec = dataclasses.replace(configs.get(ARCH), smoke=widened())
    real = configs.get
    configs.get = lambda a: spec if a == ARCH else real(a)


def _trace() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.zipf(1.3, CHUNK * CHUNKS).astype(np.uint32) % 300


def _bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.astype(np.int64) & 0xFFFFFFFF


def _worker(rank: int, tmp: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core import admission, kway
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.core.sharded import (ShardedCache, ShardedConfig,
                                          shard_of)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    out = {}
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("sets",))
    cfg = ShardedConfig(cache=KWayConfig(num_sets=SETS, ways=WAYS,
                                         policy=Policy.LRU),
                        num_shards=WORLD, backend="torch")
    trace = _trace()
    for label, tl in (("lru", None),
                      ("tinylfu", admission.TinyLFUConfig(**TL))):
        sc = ShardedCache(cfg, mesh)
        st = sc.init()
        sk = sc.init_sketches(tl) if tl is not None else None
        chunks = []
        for c in range(CHUNKS):
            keys = trace[c * CHUNK:(c + 1) * CHUNK]
            kw = {} if tl is None else {"tinylfu": tl, "sketches": sk}
            st, *o = sc.access(st, keys, keys.astype(np.int32), **kw)
            if tl is not None:
                sk = o.pop()
            chunks.append([_bits(x).tolist() for x in o])
        out[label] = {"chunks": chunks, "state": {
            k: _bits(v).tolist() for k, v in kway.state_to_numpy(
                sc.gather_state(st)).items()}}
        if tl is not None:
            out[label]["sketch"] = {
                k: _bits(v).tolist() for k, v in admission.sketch_to_numpy(
                    sc.gather_state(sk)).items()}
        out[label]["replay_hits"] = sc.replay(trace, CHUNK, tinylfu=tl)[0]
        out[label]["global_keys"] = _bits(
            sc.global_view(st).keys).tolist()

    # collectives: none inside a shard's access, one gather per call
    sc = ShardedCache(cfg, mesh)
    st = sc.init()
    keys = trace[:CHUNK]
    kt = sc.backend.keys(keys)
    with CommDebugMode() as inner:
        sc.backend.access(shard_of(st, 0), kt, kt, None,
                          torch.ones(CHUNK, dtype=torch.bool))
    with CommDebugMode() as whole:
        sc.access(st, keys, keys.astype(np.int32))
    out["comm_inner"] = inner.get_total_counts()
    out["comm_access"] = {str(k): v for k, v in
                          whole.get_comm_counts().items()}

    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                            "model"))
    out["loss"] = _loss_checks(mesh2)
    out["attention"] = _attention_checks(mesh2, SPLIT_CASES)
    # a (1, 4) mesh over the same ranks: heads the model axis does not
    # divide but shares a factor with, in gcd(H, 4) groups
    mesh4 = init_device_mesh("cpu", (1, WORLD),
                             mesh_dim_names=("data", "model"))
    out["attention_groups"] = _attention_checks(mesh4, GROUP_CASES)
    out["decode_groups"] = _decode_checks(mesh4, GROUP_CASES)
    out["ssd_heads"] = _ssd_checks(mesh4)

    # the trainer on a 2x2 mesh, its blocks rematerialised (counted)
    _use_widened()
    entered = []
    real = lm.checkpoint
    lm.checkpoint = lambda fn, *a, **kw: (entered.append(fn),
                                          real(fn, *a, **kw))[1]
    try:
        run = train.run(train.parse(TRAIN + ["--data", "2", "--model", "2"]))
    finally:
        lm.checkpoint = real
    out["remat_blocks"] = len(entered)
    out["losses"] = run.losses
    out["sharded_params"] = sum(
        isinstance(p, DTensor) and any(isinstance(x, Shard)
                                       for x in p.placements)
        for p in run.model.parameters())
    out["sharded_state"] = sum(
        any(isinstance(x, Shard) for x in t.placements)
        for t in run.opt_state["master"].values())
    # one more update on the last step's gradients: its norm (local sums
    # of squares summed over the mesh dims that shard each leaf) against
    # the gathered gradients' norm
    grads = {n: p.grad for n, p in run.model.named_parameters()}
    want = sum(float(g.full_tensor().double().square().sum())
               for g in grads.values() if g is not None) ** 0.5
    _, _, om = adamw.update(adamw.AdamWConfig(), grads, run.opt_state,
                            run.model)
    out["grad_norm"] = [float(om["grad_norm"]), want]

    # the elastic restore: the one-device checkpoint onto the 2x2 mesh
    rest = train.run(train.parse(TRAIN + ["--data", "2", "--model", "2",
                                          "--ckpt-dir", f"{tmp}/ckpt"]))
    full = {n: p.full_tensor().float().numpy()
            for n, p in rest.model.named_parameters()}
    full.update({f"master.{n}": t.full_tensor().numpy()
                 for n, t in rest.opt_state["master"].items()})
    if rank == 0:
        np.savez(f"{tmp}/restored.npz", **full)
        out["restored_start"] = rest.start_step
        with open(f"{tmp}/out.json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


class _Shapes(StepCounter):
    """Records the shape of every float32 tensor a rank's local ops create
    (the ops DTensor runs to infer global shapes are not seen)."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def _track(self, t, op=""):
        if t.dtype == torch.float32:
            self.shapes.add(tuple(t.shape))
        super()._track(t, op)


def _loss_checks(mesh) -> dict:
    """The vocabulary-parallel loss on float32 logits sharded [data, model]
    against ``cross_entropy`` on the full tensors (every rank draws the
    same ones): loss, logits gradient, the collectives of its forward and
    backward, and whether any local op made a [rows, S, padded vocab]
    tensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.train.step import cross_entropy

    cfg = widened()
    vp = lm.padded_vocab(cfg)
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(4, 16, vp, generator=g) * 4
    labels = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    full = logits.clone().requires_grad_(True)
    want = cross_entropy(cfg, full, labels, z_loss=1e-4)
    want.backward()
    dl = distribute_tensor(logits, mesh, [Shard(0), Shard(2)])
    dl.requires_grad_(True)
    dlab = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
    rec = _Shapes()
    with rec:
        with CommDebugMode() as fwd:
            loss = cross_entropy(cfg, dl, dlab, z_loss=1e-4)
        with CommDebugMode() as bwd:
            loss.backward()
    grad = dl.grad.full_tensor()
    return {
        "loss": [float(loss.full_tensor()), float(want)],
        "grad_err": float(torch.linalg.vector_norm(grad - full.grad)
                          / torch.linalg.vector_norm(full.grad)),
        "fwd": {str(k): v for k, v in fwd.get_comm_counts().items()},
        "bwd": bwd.get_total_counts(),
        "global_shape": (4, 16, vp) in rec.shapes,
        "local_shape": (2, 16, vp // 2) in rec.shapes,
    }


#: attention layers on the 2x2 mesh: name -> (heads, KV heads, heads a
#: rank's scores hold)
SPLIT_CASES = {"divides": (4, 2, 2), "does_not": (3, 1, 3)}
#: on the (1, 4) mesh: 6 / 6 heads in 2 groups of 3 (KV heads split as the
#: queries), 6 / 2 with one KV head a group, and 6 / 3 heads, whose groups
#: would read parts of two KV heads: the reference's HLO keeps every head
#: on every device there, and so does the port
GROUP_CASES = {"gcd_kv_split": (6, 6, 3), "gcd_one_kv": (6, 2, 3),
               "gcd_kv_straddles": (6, 3, 6)}


def _rel_errs(got, want, dp, plain, dx, xp) -> list:
    """[output error, then each weight's and x's gradient error], each
    relative to the largest magnitude of its reference (a weight the call
    does not read, decode's ``wk`` and ``wv``, has no gradient on either
    side)."""
    errs = [float((got.full_tensor() - want).abs().max()
                  / want.abs().max())]
    for k in plain:
        gw = plain[k].grad
        if gw is None:
            assert dp[k].grad is None, k
            continue
        errs.append(float((dp[k].grad.full_tensor() - gw).abs().max()
                          / gw.abs().max()))
    gx = xp.grad
    errs.append(float((dx.grad.full_tensor() - gx).abs().max()
                      / gx.abs().max()))
    return errs


def _attention_weights(h, kvh, d, hd, seed):
    g = torch.Generator().manual_seed(seed)
    return g, {"wq": torch.randn(d, h * hd, generator=g) * 0.3,
               "wk": torch.randn(d, kvh * hd, generator=g) * 0.3,
               "wv": torch.randn(d, kvh * hd, generator=g) * 0.3,
               "wo": torch.randn(h * hd, d, generator=g) * 0.3}


def _on_mesh(p, x, mesh):
    """Plain weights and input -> (leaf copies, DTensor weights and
    input): ``wq`` and ``wv`` split on their heads, ``wk`` on its input
    as a large leaf of a KV-narrow layer is, ``wo`` on its heads, x on
    its batch."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = {"wq": Shard(1), "wk": Shard(0), "wv": Shard(1), "wo": Shard(0)}
    plain = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    dp = {k: distribute_tensor(v, mesh, [Replicate(), pl[k]])
          .requires_grad_(True) for k, v in p.items()}
    dx = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    dx.requires_grad_(True)
    return plain, dp, dx


def _attention_checks(mesh, cases) -> dict:
    """``layers.attention`` on float32 DTensors of ``mesh`` (``_on_mesh``)
    against the same call on plain tensors, for each of ``cases``.
    -> {name: (head shards, output error, largest gradient error, the
    local score shapes)}."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L

    res = {}
    for name, (h, kvh, _) in cases.items():
        d, hd = 32, 16
        g, p = _attention_weights(h, kvh, d, hd, h * 10 + kvh)
        x = torch.randn(4, 24, d, generator=g)
        pos = torch.arange(24)[None]
        kw = dict(num_heads=h, num_kv_heads=kvh, head_dim=hd, softcap=20.0,
                  window=0, q_chunk=8)
        plain, dp, dx = _on_mesh(p, x, mesh)
        xp = x.clone().requires_grad_(True)
        want, _ = L.attention(plain, xp, pos, **kw)
        want.square().sum().backward()
        rec = _Shapes()
        with implicit_replication(), rec:
            got, _ = L.attention(dp, dx, pos, **kw)
            got.square().sum().backward()
        errs = _rel_errs(got, want, dp, plain, dx, xp)
        res[name] = [L.head_shards(dx, dp["wq"], h, kvh) is not None,
                     errs[0], max(errs[1:]),
                     sorted({s for s in rec.shapes
                             if len(s) == 5 and s[-2:] == (8, 24)})]
    return res


def _decode_checks(mesh, cases) -> dict:
    """``layers.decode_attention`` (one token against a 20-position cache
    and its own K / V) on ``mesh`` against the plain call, as
    ``_attention_checks``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L

    res = {}
    for name, (h, kvh, _) in cases.items():
        d, hd, t = 32, 16, 20
        g, p = _attention_weights(h, kvh, d, hd, h * 10 + kvh + 5)
        x = torch.randn(4, 1, d, generator=g)
        pos = torch.tensor([3, 9, 14, 19])
        kc, vc, kn, vn = (torch.randn(4, n, kvh, hd, generator=g)
                          for n in (t, t, 1, 1))
        kw = dict(num_heads=h, num_kv_heads=kvh, head_dim=hd, softcap=20.0,
                  window=0)
        plain, dp, dx = _on_mesh(p, x, mesh)
        xp = x.clone().requires_grad_(True)
        want = L.decode_attention(plain, xp, pos, kc, vc, kv_new=(kn, vn),
                                  **kw)
        want.square().sum().backward()
        dc = [distribute_tensor(c, mesh, [Shard(0), Replicate()])
              for c in (kc, vc, kn, vn)]
        dpos = distribute_tensor(pos, mesh, [Shard(0), Replicate()])
        rec = _Shapes()
        with implicit_replication(), rec:
            got = L.decode_attention(dp, dx, dpos, dc[0], dc[1],
                                     kv_new=(dc[2], dc[3]), **kw)
            got.square().sum().backward()
        errs = _rel_errs(got, want, dp, plain, dx, xp)
        res[name] = [L.head_shards(dx, dp["wq"], h, kvh) is not None,
                     errs[0], max(errs[1:]),
                     sorted({s for s in rec.shapes
                             if len(s) == 5 and s[-2:] == (1, t)})]
    return res


#: the SSD layer of ``_ssd_checks``: 6 heads of 16 lanes (d_inner 96),
#: which a 4-way model axis splits 2, 2, 2 and none
SSD_DIMS = dict(d_model=48, d_inner=96, nheads=6, head_dim=16, state=8,
                conv=4)


def _ssd_checks(mesh) -> dict:
    """``layers.ssd_scan`` on float32 DTensors of ``mesh`` (``in_proj``
    and ``out_proj`` split on d_model and d_inner, as the sharding rule
    splits mamba2's, the rest replicated) against the plain call.  ->
    [SSD heads of each rank, output error, largest gradient error, the
    local quadratic shapes]."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L

    dims = L.SSMDims(**SSD_DIMS)
    d, di, n, nh = dims.d_model, dims.d_inner, dims.state, dims.nheads
    g = torch.Generator().manual_seed(11)
    p = {"in_proj": torch.randn(d, 2 * di + 2 * n + nh, generator=g) * 0.2,
         "conv_w": torch.randn(dims.conv, di + 2 * n, generator=g) * 0.5,
         "dt_bias": torch.randn(nh, generator=g) * 0.5,
         "A_log": torch.randn(nh, generator=g) * 0.5,
         "D": torch.randn(nh, generator=g),
         "norm": torch.randn(di, generator=g) * 0.1,
         "out_proj": torch.randn(di, d, generator=g) * 0.2}
    x = torch.randn(4, 32, d, generator=g)
    plain = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xp = x.clone().requires_grad_(True)
    want, (st, _) = L.ssd_scan(plain, xp, dims, chunk=8)
    (want.square().sum() + st.sum()).backward()
    pl = {"in_proj": Shard(0), "out_proj": Shard(0)}
    dp = {k: distribute_tensor(v, mesh, [Replicate(),
                                         pl.get(k, Replicate())])
          .requires_grad_(True) for k, v in p.items()}
    dx = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    dx.requires_grad_(True)
    rec = _Shapes()
    with implicit_replication(), rec:
        got, (dst, _) = L.ssd_scan(dp, dx, dims, chunk=8)
        (got.square().sum() + dst.sum()).backward()
    errs = _rel_errs(got, want, dp, plain, dx, xp)
    plan = L.ssd_heads(dx, dp["out_proj"], dp["in_proj"], nh)
    return [None if plan is None else len(range(nh)[plan.heads]), errs[0],
            max(errs[1:]),
            sorted({s for s in rec.shapes
                    if len(s) == 5 and s[2:4] == (8, 8)})]


def _reference_runs():
    jcfg = JShardedConfig(cache=JConfig(num_sets=SETS, ways=WAYS,
                                        policy=JPolicy.LRU),
                          num_shards=WORLD)
    trace = _trace()
    out = {}
    for label, tl in (("lru", None),
                      ("tinylfu", jadm.TinyLFUConfig(**TL))):
        j = JSharded(jcfg)
        st = j.init()
        sk = j.init_sketches(tl) if tl is not None else None
        chunks = []
        for c in range(CHUNKS):
            keys = trace[c * CHUNK:(c + 1) * CHUNK]
            kw = {} if tl is None else {"tinylfu": tl, "sketches": sk}
            st, *o = j.access(st, keys, keys.astype(np.int32), **kw)
            if tl is not None:
                sk = o.pop()
            chunks.append([_bits(x).tolist() for x in o])
        out[label] = {"chunks": chunks,
                      "state": jax.tree.map(_bits, st),
                      "sketch": None if sk is None else jax.tree.map(_bits,
                                                                     sk),
                      "replay_hits": j.replay(trace, CHUNK,
                                              tinylfu=tl)[0]}
    one = JSharded(dataclasses.replace(jcfg, num_shards=1))
    st = one.init()
    chunks = []
    for c in range(CHUNKS):
        keys = trace[c * CHUNK:(c + 1) * CHUNK]
        st, *o = one.access(st, keys, keys.astype(np.int32))
        chunks.append([_bits(x).tolist() for x in o])
    out["unsharded"] = {"chunks": chunks, "state": jax.tree.map(_bits, st)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs and the one-device trainer here; then the
    4-rank group."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("mesh"))
    ref = _reference_runs()
    real_get = configs.get
    _use_widened()
    try:
        one = train.run(train.parse(TRAIN + ["--ckpt-dir",
                                             f"{tmp}/ckpt_one"]))
    finally:
        configs.get = real_get
    shutil.copytree(f"{tmp}/ckpt_one", f"{tmp}/ckpt")
    mp.spawn(_worker, args=(tmp,), nprocs=WORLD, join=True)
    with open(f"{tmp}/out.json") as f:
        got = json.load(f)
    saved = os.path.join(f"{tmp}/ckpt_one", "step_000000003")
    return ref, one, got, np.load(f"{tmp}/restored.npz"), saved


@pytest.mark.parametrize("label", ["lru", "tinylfu"])
def test_mesh_cache_equals_reference_sharded(runs, label):
    ref, _, got, _, _ = runs
    for c, (want, have) in enumerate(zip(ref[label]["chunks"],
                                         got[label]["chunks"])):
        for i, (w, h) in enumerate(zip(want, have)):
            np.testing.assert_array_equal(h, w, err_msg=f"chunk {c} out {i}")
    for leaf in LEAVES:
        np.testing.assert_array_equal(
            np.asarray(got[label]["state"][leaf]),
            np.asarray(getattr(ref[label]["state"], leaf)), err_msg=leaf)
    if label == "tinylfu":
        for leaf in ("packed", "door", "additions"):
            np.testing.assert_array_equal(
                np.asarray(got[label]["sketch"][leaf]),
                np.asarray(getattr(ref[label]["sketch"], leaf)),
                err_msg=leaf)
    assert got[label]["replay_hits"] == ref[label]["replay_hits"]


def test_mesh_cache_lru_equals_unsharded(runs):
    """Hits, evictions (keys and flags) and final keys / vals: the paper's
    contract, across four processes."""
    ref, _, got, _, _ = runs
    for c, (want, have) in enumerate(zip(ref["unsharded"]["chunks"],
                                         got["lru"]["chunks"])):
        for i in (0, 2, 3):                      # hit, evicted key, flag
            np.testing.assert_array_equal(have[i], want[i],
                                          err_msg=f"chunk {c} out {i}")
    st = ref["unsharded"]["state"]
    np.testing.assert_array_equal(
        np.sort(np.asarray(got["lru"]["global_keys"]).reshape(-1)),
        np.sort(np.asarray(st.keys).reshape(-1)))


def test_mesh_cache_collectives(runs):
    _, _, got, _, _ = runs
    assert got["comm_inner"] == 0
    assert sum(got["comm_access"].values()) == 1
    assert any("allgather" in k or "all_gather" in k
               for k in got["comm_access"])


def test_mesh_trainer_losses_match_one_device(runs):
    _, one, got, _, _ = runs
    assert got["sharded_params"] > 0 and got["sharded_state"] > 0
    assert got["remat_blocks"] == 3 * widened().num_layers
    np.testing.assert_allclose(got["losses"], one.losses, rtol=1e-3)
    assert len(one.losses) == 3 and np.isfinite(one.losses).all()


def test_mesh_optimizer_norm_counts_each_element_once(runs):
    """The optimizer's norm on the 2x2 mesh (replicated, model-sharded and
    ZeRO-sharded leaves) equals the norm of the gathered gradients."""
    got, want = runs[2]["grad_norm"]
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_vocab_parallel_loss_equals_one_device(runs):
    """The loss of vocabulary-sharded float32 logits and its logits
    gradient equal one device's within 1e-6 relative (the gradient in L2:
    its elements carry the log-sum-exp's last-bit difference, about 1e-7
    of 9, into every softmax lane)."""
    _, _, got, _, _ = runs
    loss, want = got["loss"]["loss"]
    assert abs(loss - want) <= 1e-6 * abs(want)
    assert got["loss"]["grad_err"] <= 1e-6


def test_vocab_parallel_loss_collectives(runs):
    """Three all-reduces (max, sum of exp, gold) in the forward, and the
    backward adds no collective."""
    _, _, got, _, _ = runs
    fwd = got["loss"]["fwd"]
    assert sum(fwd.values()) == 3
    assert all("all_reduce" in k for k in fwd)
    assert got["loss"]["bwd"] == 0


def test_vocab_parallel_loss_no_global_logits(runs):
    """No rank creates a tensor of the global [rows, S, padded vocab]
    shape in the loss or its backward; each holds its own lanes."""
    _, _, got, _, _ = runs
    assert not got["loss"]["global_shape"]
    assert got["loss"]["local_shape"]


@pytest.mark.parametrize("name", ["divides", "does_not"])
def test_attention_on_head_shards_equals_plain(runs, name):
    """Attention on the 2x2 mesh equals the plain call within 2e-5
    (float32), output and gradients; where the model axis divides the
    heads each rank's scores hold its 2 heads, else all 3."""
    _, _, got, _, _ = runs
    sharded, out_err, grad_err, scores = got["attention"][name]
    assert out_err <= 2e-5 and grad_err <= 2e-5
    assert sharded == (name == "divides")
    heads = [s[1] * s[2] for s in scores]
    assert heads and all(h == (2 if sharded else 3) for h in heads)


@pytest.mark.parametrize("kind", ["attention_groups", "decode_groups"])
@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_attention_in_head_groups_equals_plain(runs, kind, name):
    """Attention and decode attention on a (1, 4) mesh whose model axis
    does not divide the 6 heads equal the plain call within 2e-5
    (float32), output and every gradient (wq, wk, wv, wo, x; decode reads
    no wk or wv); each rank's
    scores hold H / gcd(H, 4) = 3 heads where the reference's HLO splits
    them so, else all 6."""
    _, _, got, _, _ = runs
    sharded, out_err, grad_err, scores = got[kind][name]
    assert out_err <= 2e-5 and grad_err <= 2e-5, (out_err, grad_err)
    want = GROUP_CASES[name][2]
    assert sharded == (want < GROUP_CASES[name][0])
    heads = [s[1] * s[2] for s in scores]
    assert heads and all(h == want for h in heads), scores


def test_ssd_on_head_shards_equals_plain(runs):
    """The Mamba2 block on the (1, 4) mesh, its 6 SSD heads split 2, 2, 2
    and none over the model axis, equals the plain call within 2e-5
    (float32), output, final state and every gradient; rank 0's
    quadratic [B, nc, Q, Q, h] temporaries hold its 2 heads, none all 6
    (the head-free product C.B and its gradient have h = 1)."""
    _, _, got, _, _ = runs
    heads, out_err, grad_err, quad = got["ssd_heads"]
    assert heads == 2
    assert out_err <= 2e-5 and grad_err <= 2e-5, (out_err, grad_err)
    assert quad and max(s[4] for s in quad) == 2, quad


def test_unsharded_checkpoint_restores_onto_mesh(runs):
    _, one, got, restored, saved = runs
    assert got["restored_start"] == 3
    for n, p in one.model.named_parameters():
        np.testing.assert_array_equal(restored[n], p.detach().float().numpy(),
                                      err_msg=n)
    for n, t in one.opt_state["master"].items():
        np.testing.assert_array_equal(restored[f"master.{n}"], t.numpy(),
                                      err_msg=n)
    assert os.path.isdir(saved)
