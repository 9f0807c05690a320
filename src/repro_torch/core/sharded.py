"""Set-sharded execution: the paper's "Alice and Bob never synchronize"
parallelism, with the request router on the device.

Counterpart of ``repro/core/sharded.py``.  Sets are data-independent, so a
global cache of S sets splits into D sub-caches of S/D sets with no
cross-shard traffic.  The only cross-shard work is routing each key to the
shard that owns its set (``core/router.py``: owner = high bits of the
global set index, one stable sort into a fixed ``[D, capacity]`` bucket
layout, the inverse permutation back).

On one card the shard axis is the leading dimension of the state: the
per-shard ``KWayState`` lanes stacked as ``[D, S/D, k]``, the clock
``[D]``.  Where the reference ``vmap``s the shard body, the port loops over
the D shards and calls the backend once per shard's bucket: on the
``cuda`` backend D kernel-2 launches per chunk (``access``), and D
kernel-1 launches per ``get`` / ``put`` / ``peek_victims``.  The resident
replay routes every chunk of the trace in one call and hands each shard
its whole ``[steps, capacity]`` stream in one ``CacheBackend.replay``: D
launches of kernel 3 (kernel 4 with a hierarchy, each shard with its own
fresh L1).  A shard whose stream kernel 3 does not take
(``kernels/replay.py`` ``resident_fits``) records a ``smem_budget`` event
and takes the chunked path, as the backend does for an unsharded replay.

Admission composes by privatization: the TinyLFU sketch is stacked per
shard (``[D, ...]``) and record -> peek -> admit run inside the shard's
step on its own stream.

Because every request of one set lands in the same bucket in arrival
order, each shard's batched conflict resolution matches the unsharded
cache request for request: hits, evictions and final keys / vals are equal
for LRU, LFU and FIFO.  Timestamps are shard-local (``t+i`` with ``i`` the
lane's index in its bucket), so ``meta_a`` and the clocks differ from the
unsharded cache's, and RANDOM and HYPERBOLIC, which score on absolute
times, agree only statistically.

Differences from the reference: ``ShardedConfig`` has no ``donate``
field (the reference's lets XLA reuse the caller's buffers; the port
returns new tensors and has no in-place option to switch); the
reference's ``trace_counts``
count XLA compilations, which the port does not have, so the reference's
compile-count tests (``tests/test_router.py:177,203``) have no port
counterpart.

Mesh execution (``ShardedCache(cfg, mesh)``, a ``DeviceMesh`` with a
``"sets"`` axis of exactly ``num_shards`` devices): SPMD, one process a
device, each holding shard ``rank`` (its state is that shard alone,
``[1, S/D, k]``).  Every rank routes the whole replicated batch, takes its
own bucket and runs its local backend on it (on ``cuda``: kernel 2 per
``access``, and kernel 1 under TinyLFU); one ``all_gather_into_tensor`` of
the bucketed answers per call precedes the unscatter, so every rank holds
the whole batch's answers.  The cache operations issue no collective: the
paper's "Alice and Bob never synchronize".  A ``replay`` adds one
all-reduce of the hit count at its end.  ``resident=True`` refuses a
mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import admission, router
from repro_torch.core.admission import TinyLFUConfig, TinyLFUState
from repro_torch.core.backend import HIER_TINYLFU, _vals, make_backend
from repro_torch.core.kway import KWayConfig, KWayState

@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    """Global cache shape + how to split its set axis."""

    cache: KWayConfig            # GLOBAL shape: cache.num_sets over all shards
    num_shards: int = 1
    backend: str = "cuda"
    # Router bucket capacity (requests per shard per step).  None: the
    # batch size, which can never overflow.  Smaller values defer the lanes
    # ranked past it (reported, not dropped).
    route_capacity: Optional[int] = None

    def __post_init__(self):
        assert self.num_shards >= 1
        assert self.num_shards & (self.num_shards - 1) == 0, \
            "num_shards must be a power of two (it splits the set-index bits)"
        assert self.cache.num_sets % self.num_shards == 0 and \
            self.cache.num_sets >= self.num_shards
        assert self.route_capacity is None or self.route_capacity >= 1

    @property
    def local(self) -> KWayConfig:
        """Per-shard cache config: same ways/policy, S/D sets."""
        return dataclasses.replace(
            self.cache, num_sets=self.cache.num_sets // self.num_shards)

    def capacity_for(self, batch: int) -> int:
        return batch if self.route_capacity is None else self.route_capacity


def shard_of(tree, i: int):
    """Shard ``i`` of a stacked ``KWayState`` / ``TinyLFUState`` /
    ``HierState`` (views of its tensors)."""
    if tree is None:
        return None
    return dataclasses.replace(tree, **{
        f.name: (shard_of(v, i) if dataclasses.is_dataclass(v)
                 else None if v is None else v[i])
        for f in dataclasses.fields(tree)
        for v in (getattr(tree, f.name),)})


def stack_shards(trees: list):
    """Stack per-shard states (any dataclass of tensors) on a new leading
    shard axis."""
    first = trees[0]
    out = {}
    for f in dataclasses.fields(first):
        vs = [getattr(t, f.name) for t in trees]
        if vs[0] is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(vs[0]):
            out[f.name] = stack_shards(vs)
        else:
            out[f.name] = torch.stack(vs)
    return dataclasses.replace(first, **out)


class ShardedCache:
    """A K-way cache whose set axis is sharded D ways: on one card, or one
    shard a device over ``mesh``'s ``sets`` axis.

    ``get`` / ``put`` / ``peek_victims`` follow the CacheBackend contract
    closely enough for ``serve/engine.py`` to use a ShardedCache as its
    prefix-cache backend: ``put(slot_value=True)`` stores and reports
    *global* slot ids (``global_set * ways + way`` with ``global_set =
    d * S/D + local_set``).  ``device=None`` is the card."""

    traceable = True

    def __init__(self, cfg: ShardedConfig, mesh=None, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.group = None
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None) or ()
            if "sets" not in names or \
                    mesh.size(names.index("sets")) != cfg.num_shards:
                shape = dict(zip(names, getattr(mesh, "shape", ())))
                raise ValueError(
                    "mesh must carry a 'sets' axis of exactly num_shards "
                    f"devices (one shard per device); got axes "
                    f"{shape} for num_shards={cfg.num_shards}")
            self.group = mesh.get_group("sets")
            self.rank = mesh.get_local_rank("sets")
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda" else mesh.device_type)
        self.backend = make_backend(cfg.backend, cfg.local, device)
        if not self.backend.traceable:
            raise ValueError(
                f"backend {cfg.backend!r} is host Python and cannot be "
                "sharded; shard the 'torch' or 'cuda' backend")
        self.device = self.backend.device

    # ------------------------------------------------------------- plumbing
    def _shards(self) -> list:
        """(shard id, index in the held state) of the shards this process
        holds: all D on one device, its own on a mesh."""
        if self.mesh is None:
            return [(i, i) for i in range(self.cfg.num_shards)]
        return [(self.rank, 0)]

    def _collect(self, parts: list) -> torch.Tensor:
        """Per-held-shard answers (each [capacity] or [F, capacity]) ->
        [D, ...] for every shard: a stack on one device, one
        ``all_gather_into_tensor`` over the ``sets`` axis on a mesh."""
        mine = torch.stack(parts)
        if self.mesh is None:
            return mine
        out = torch.empty((self.cfg.num_shards,) + tuple(mine.shape[1:]),
                          dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(out, mine.contiguous(), group=self.group)
        return out

    def _gather_answers(self, outs: list) -> tuple:
        """Per-held-shard tuples of [capacity] answers -> one [D, capacity]
        tensor per field: a stack per field on one device, packed into one
        int32 buffer for the gather on a mesh."""
        if self.mesh is None:
            return tuple(torch.stack(c) for c in zip(*outs))
        dtypes = [t.dtype for t in outs[0]]
        packed = self._collect([torch.stack([t.to(torch.int32) for t in o])
                                for o in outs])
        return tuple(packed[:, j].to(dt) for j, dt in enumerate(dtypes))

    def init(self, *, ttl: bool = False) -> KWayState:
        st = self.backend.init(ttl=ttl)
        return stack_shards([st] * len(self._shards()))

    def init_sketches(self, tinylfu: TinyLFUConfig) -> TinyLFUState:
        """Per-shard TinyLFU sketches, stacked on the shard axis [D, ...]
        (on a mesh, this rank's alone)."""
        sk = admission.make_sketch(tinylfu, self.device)
        return stack_shards([sk] * len(self._shards()))

    def gather_state(self, tree):
        """A held state (or sketch stack) -> every shard's, [D, ...]: the
        state itself on one device, each lane all-gathered on a mesh."""
        if self.mesh is None or tree is None:
            return tree
        return dataclasses.replace(tree, **{
            f.name: (self.gather_state(v) if dataclasses.is_dataclass(v)
                     else None if v is None else self._collect([v[0]]))
            for f in dataclasses.fields(tree)
            for v in (getattr(tree, f.name),)})

    def owner_of(self, keys) -> np.ndarray:
        """Owning shard per key: the high bits of the global set index."""
        return router.owner_of(
            self.backend.keys(keys), self.cfg.cache.num_sets, self.cfg.num_shards,
            self.cfg.cache.seed).cpu().numpy()

    def _route(self, keys, enabled, capacity) -> router.RoutePlan:
        owner = router.owner_of(keys, self.cfg.cache.num_sets,
                                self.cfg.num_shards, self.cfg.cache.seed)
        return router.route(owner, self.cfg.num_shards, capacity, enabled)

    def _bucket(self, plan, values, capacity, fill):
        return router.bucket(plan, values, self.cfg.num_shards, capacity,
                             fill)

    def _mask(self, enabled, b):
        if enabled is None:
            return torch.ones(b, dtype=torch.bool, device=self.device)
        return torch.as_tensor(enabled, dtype=torch.bool).to(self.device)

    def _local_access(self, tinylfu, two_phase, keys, vals, en, sketch,
                      state: KWayState, ttls=None):
        """One shard's step on its own bucket ([capacity] lanes): TinyLFU
        record -> peek -> admit on the shard's private sketch, then the
        fused access (or the two-phase oracle).  Deadlines are
        chunk-constant (``clock + 2*capacity + ttl``), so bucketing's lane
        permutation cannot perturb them."""
        be = self.backend
        admit = None
        if tinylfu is not None:
            sketch = admission.record(tinylfu, sketch, keys, enabled=en)
            vkeys, vvalid = be.peek_victims(state, keys)
            admit = admission.admit(tinylfu, sketch, keys, vkeys, vvalid)
        if two_phase:
            out = be.access_two_phase(state, keys, vals, admit, en)
        else:
            kw = {} if ttls is None else {"ttls": ttls}
            out = be.access(state, keys, vals, admit, en, **kw)
        return out, sketch

    def _step(self, tinylfu, two_phase, keys, vals, enabled, state, sketches,
              capacity, ttls=None):
        """Route one batch, run every held shard on its bucket.
        -> (state', sketches', plan, per-held-shard outputs of (hit, vals,
        ek, ev), bucket mask [D, capacity])."""
        plan = self._route(keys, enabled, capacity)
        kb = self._bucket(plan, keys, capacity, 0)
        vb = self._bucket(plan, vals, capacity, 0)
        eb = router.bucket_mask(plan, self.cfg.num_shards, capacity)
        tb = None if ttls is None else self._bucket(plan, ttls, capacity, 0)
        states, sks, outs = [], [], []
        for i, h in self._shards():
            (st, hit, out, ek, ev), sk = self._local_access(
                tinylfu, two_phase, kb[i], vb[i], eb[i],
                shard_of(sketches, h), shard_of(state, h),
                None if tb is None else tb[i])
            states.append(st)
            sks.append(sk)
            outs.append((hit, out, ek, ev))
        sketches = None if sketches is None else stack_shards(sks)
        return stack_shards(states), sketches, plan, outs, eb

    # ------------------------------------------------------------------ API
    def access(self, state: KWayState, keys, vals, *, tinylfu=None,
               sketches=None, two_phase=False, return_deferred=False):
        """Batched get-or-insert across all shards, routed on the device.

        Returns (state', hit[B], vals[B], evicted_keys[B], evicted_valid[B])
        in the original request order; with ``return_deferred=True`` the
        overflow-defer mask is appended.  With ``tinylfu`` the per-shard
        ``sketches`` (``init_sketches``) ride along and the updated stack
        is appended to the return."""
        keys = self.backend.keys(keys)
        vals = _vals(vals, self.device)
        b = keys.shape[0]
        capacity = self.cfg.capacity_for(b)
        if tinylfu is not None and sketches is None:
            sketches = self.init_sketches(tinylfu)
        state, sk, plan, outs, _ = self._step(
            tinylfu, two_phase, keys, vals, self._mask(None, b), state,
            sketches if tinylfu is not None else None, capacity)
        hit, out, ek, ev = self._gather_answers(outs)
        ret = (state, router.unscatter(plan, hit, False),
               router.unscatter(plan, out, -1),
               router.unscatter(plan, ek, 0),
               router.unscatter(plan, ev, False))
        if return_deferred:
            ret = ret + (plan.deferred,)
        if tinylfu is not None:
            ret = ret + (sk,)
        return ret

    def bucket_all(self, chunks, en, capacity: int, tt=None):
        """Route EVERY chunk of a replay in one call (a sort along each
        chunk, no loop over chunks).

        -> (kb int32 [D, steps, capacity], eb bool [D, steps, capacity],
        tb int32 [D, steps, capacity] | None, deferred int32 []): per-shard
        request streams in the per-chunk bucket layout the scanned replay
        routes step by step, shard-major, so each shard's trace is one
        contiguous [steps, capacity] stream (what ``CacheBackend.replay``
        consumes)."""
        plan = self._route(chunks, en, capacity)

        def tr(a):
            return a.transpose(0, 1).contiguous()

        kb = tr(self._bucket(plan, chunks, capacity, 0))
        eb = tr(router.bucket_mask(plan, self.cfg.num_shards, capacity))
        tb = None if tt is None else tr(self._bucket(plan, tt, capacity, 0))
        return kb, eb, tb, plan.deferred.sum(dtype=torch.int32)

    def _replay_resident(self, chunks, en, capacity, tinylfu, state,
                         hierarchy=None, ttls=None):
        """Resident replay: route all chunks once, then one
        ``CacheBackend.replay`` per shard on its whole stream (D launches
        of kernel 3 on ``cuda``, or of kernel 4 with ``hierarchy``, where
        each shard gets its own fresh L1 and the stacked state comes back
        as a ``HierState`` of per-shard tiers)."""
        kb, eb, tb, defers = self.bucket_all(chunks, en, capacity, ttls)
        sketches = (self.init_sketches(tinylfu) if tinylfu is not None
                    else None)
        hits = torch.zeros((), dtype=torch.int64, device=self.device)
        shard_states = []
        for i in range(self.cfg.num_shards):
            h, _, st_i, _ = self.backend.replay(
                shard_of(state, i), kb[i], eb[i], tinylfu=tinylfu,
                sketch=shard_of(sketches, i), hierarchy=hierarchy,
                ttls=None if tb is None else tb[i])
            hits = hits + h.sum()
            shard_states.append(st_i)
        return int(hits), int(defers), stack_shards(shard_states)

    def replay(self, trace, batch: int, *, tinylfu=None, two_phase=False,
               state: Optional[KWayState] = None, resident: bool = False,
               hierarchy=None, ttls=None):
        """Replay a whole trace, routed on the device; the tail chunk is
        padded with disabled lanes, so every request is replayed.
        -> (hits, deferred, state'): ``hits`` over the full trace,
        ``deferred`` the overflow-deferred lanes (0 under the default
        capacity; they count as misses).

        ``resident=True`` routes every chunk up front and hands each shard
        its whole stream in one ``CacheBackend.replay`` call (D kernel-3
        launches on ``cuda``); it excludes ``two_phase``.  Otherwise each
        chunk is routed and each shard stepped in turn (D kernel-2 launches
        a chunk on ``cuda``).  ``hierarchy`` needs ``resident=True``.

        ``ttls`` (int array [len(trace)]) gives each request a time-to-live
        on the logical clock.  Deadlines are chunk-constant (``clock +
        2*capacity + ttl``) and every shard's clock advances 2*capacity a
        chunk, so the sharded expiry replay equals the unsharded one.
        Excludes ``two_phase`` and ``tinylfu``."""
        trace = np.asarray(trace, np.uint32)
        chunks_np, en_np = router.pad_chunks(trace, batch)
        chunks = self.backend.keys(chunks_np)
        en = torch.from_numpy(en_np).to(self.device)
        capacity = self.cfg.capacity_for(batch)
        tt = None
        if ttls is not None:
            if two_phase:
                raise ValueError(
                    "per-request TTLs run on the fused access path; "
                    "two_phase has no expiry semantics")
            if tinylfu is not None:
                raise ValueError(admission.TTL_EXCLUSIVE)
            if len(np.asarray(ttls)) != len(trace):
                raise ValueError(
                    f"ttls length {len(np.asarray(ttls))} != trace length "
                    f"{len(trace)}")
            tt_np = np.zeros(chunks_np.shape, np.int32)
            tt_np.reshape(-1)[: len(trace)] = np.asarray(ttls, np.int32)
            tt = torch.from_numpy(tt_np).to(self.device)
        if hierarchy is not None and hierarchy.enabled and not resident:
            raise ValueError(
                "sharded hierarchical replay runs per-shard kernels; "
                "pass resident=True")
        if resident:
            if two_phase:
                raise ValueError(
                    "resident replay is the fused access path; two_phase "
                    "is the chunked-scan oracle — use resident=False")
            if self.mesh is not None:
                raise ValueError(
                    "resident replay drives one kernel per shard from the "
                    "host; run mesh execution through the chunked path")
            if hierarchy is not None and hierarchy.enabled and \
                    tinylfu is not None:
                raise ValueError(HIER_TINYLFU)
            return self._replay_resident(
                chunks, en, capacity, tinylfu,
                state if state is not None else self.init(ttl=tt is not None),
                hierarchy=hierarchy, ttls=tt)

        if state is None:
            state = self.init(ttl=tt is not None)
        sketches = (self.init_sketches(tinylfu) if tinylfu is not None
                    else None)
        hits = torch.zeros((), dtype=torch.int64, device=self.device)
        defers = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in range(chunks.shape[0]):
            state, sketches, plan, outs, eb = self._step(
                tinylfu, two_phase, chunks[t], chunks[t], en[t], state,
                sketches, capacity, None if tt is None else tt[t])
            # hits are counted on the buckets: summing the bucketed lanes
            # equals summing the request lanes
            for (i, _), (hit, _, _, _) in zip(self._shards(), outs):
                hits = hits + (hit & eb[i]).sum()
            defers = defers + plan.deferred.sum()
        if self.mesh is not None:     # every shard's hits, once a replay
            dist.all_reduce(hits, group=self.group)
        return int(hits), int(defers), state

    # ----------------------------------------------- CacheBackend-ish ops
    # (the serve engine's prefix cache drives these; slot ids are global)
    def get(self, state: KWayState, qkeys, enabled=None):
        qkeys = self.backend.keys(qkeys)
        b = qkeys.shape[0]
        capacity = self.cfg.capacity_for(b)
        plan = self._route(qkeys, self._mask(enabled, b), capacity)
        kb = self._bucket(plan, qkeys, capacity, 0)
        eb = router.bucket_mask(plan, self.cfg.num_shards, capacity)
        states, outs = [], []
        for i, h in self._shards():
            st, hit, v = self.backend.get(shard_of(state, h), kb[i],
                                          enabled=eb[i])
            states.append(st)
            outs.append((hit, v))
        hit, v = self._gather_answers(outs)
        return (stack_shards(states), router.unscatter(plan, hit, False),
                router.unscatter(plan, v, -1))

    def put(self, state: KWayState, qkeys, qvals, admit=None, enabled=None,
            *, slot_value: bool = False):
        qkeys = self.backend.keys(qkeys)
        b = qkeys.shape[0]
        qvals = _vals(qvals, self.device)
        capacity = self.cfg.capacity_for(b)
        s_local = self.cfg.local.num_sets
        ways = self.cfg.cache.ways
        plan = self._route(qkeys, self._mask(enabled, b), capacity)
        kb = self._bucket(plan, qkeys, capacity, 0)
        vb = self._bucket(plan, qvals, capacity, 0)
        ab = self._bucket(plan, self._mask(admit, b), capacity, False)
        eb = router.bucket_mask(plan, self.cfg.num_shards, capacity)
        states, outs = [], []
        for i, h in self._shards():
            st, ek, ev, ss, sw = self.backend.put(
                shard_of(state, h), kb[i], vb[i], admit=ab[i],
                enabled=eb[i], slot_value=slot_value)
            if slot_value:
                st = _lift_slot_ids(st, ss, sw, i * s_local, ways)
            gs = torch.where(ss >= 0, ss + i * s_local, -1)
            states.append(st)
            outs.append((ek, ev, gs, sw))
        ek, ev, gs, sw = self._gather_answers(outs)
        return (stack_shards(states), router.unscatter(plan, ek, 0),
                router.unscatter(plan, ev, False),
                router.unscatter(plan, gs, -1),
                router.unscatter(plan, sw, -1))

    def peek_victims(self, state: KWayState, qkeys):
        qkeys = self.backend.keys(qkeys)
        b = qkeys.shape[0]
        capacity = self.cfg.capacity_for(b)
        plan = self._route(qkeys, self._mask(None, b), capacity)
        kb = self._bucket(plan, qkeys, capacity, 0)
        outs = [self.backend.peek_victims(shard_of(state, h), kb[i])
                for i, h in self._shards()]
        vk, vv = self._gather_answers(outs)
        return (router.unscatter(plan, vk, 0),
                router.unscatter(plan, vv, False))

    def global_view(self, state: KWayState) -> KWayState:
        """Reassemble the stacked shard states into the equivalent global
        state (sets of shard d map to global sets [d*S/D, (d+1)*S/D)).  The
        clock is summed: a diagnostic view; policy metadata keeps its
        shard-local timestamps.  On a mesh every shard is gathered first."""
        state = self.gather_state(state)
        s, k = self.cfg.cache.num_sets, self.cfg.cache.ways

        def merge(t):
            return None if t is None else t.reshape(s, k)

        return KWayState(
            keys=merge(state.keys), fprint=merge(state.fprint),
            vals=merge(state.vals), meta_a=merge(state.meta_a),
            meta_b=merge(state.meta_b), clock=state.clock.sum(
                dtype=torch.int32), expiry=merge(state.expiry))


def _lift_slot_ids(st: KWayState, ss, sw, set_offset: int,
                   ways: int) -> KWayState:
    """The local put stored local slot ids as payload: overwrite each landed
    lane's value with its global id.  Two landed lanes may share a (set,
    way) (a present key plus an insert victimizing its way); both carry the
    same recomputed id, and only the last of them writes, so the scatter
    has unique indices.  Lanes that did not land write a sink slot past the
    end, which is dropped."""
    from repro_torch.core.kway import _last_writer, _write
    landed = ss >= 0
    flat = torch.where(landed, ss * ways + sw, 0)
    gval = ((ss + set_offset) * ways + sw).to(torch.int32)
    keep = _last_writer(flat, landed)
    return dataclasses.replace(st, vals=_write(st.vals, flat, keep, gval))

