"""Declarative sweep runner: the measurement engine behind every hit-ratio
figure.

Counterpart of ``repro/eval/runner.py``.  A sweep is a grid of (trace
family x policy x associativity x backend x admission x seed) points, all
replayed with the exact sequential semantics of ``core/simulate.replay``
(B = 1: get at logical time t, put-on-miss at t+1).

``torch`` points whose cache *shape* matches are stacked along a leading
config axis and replayed by one step written over that axis with batched
indexing (the counterpart of the reference's vmapped ``lax.scan``).  The
traces are data, and so is the eviction policy: ``policies.*_dyn`` select
a policy per config lane from a policy-index tensor (evaluating only the
policies the group's lanes hold), so LRU, LFU, FIFO, RANDOM and HYPERBOLIC
share one group.  On the card the step is captured once per shape group
as a CUDA graph and replayed once per request (the counterpart of the
reference's one compile per cache shape; eager, every small op of the
step is a launch from the host); on the CPU it runs eagerly.  ``capture_counts()`` tallies the captures per group (on the
CPU, the group replays) and ``run_hit_ratio_sweep`` asserts at most one
per shape group.

``cuda`` points run one kernel-3 launch each: the ``cuda`` backend's
``replay`` on ``[N, 1]`` chunks (TinyLFU takes kernel 3's one-block form
below 16 lanes), which is what ``simulate.replay`` does on ``cuda``.  The
reference's pallas group instead probes with kernel 1 once or twice per
request inside its scan (``repro/eval/runner.py:274-352``): on the H100
that would be N host launches per point, while kernel 3 replays the whole
trace in one launch and is held bit for bit to the same B = 1 semantics
(``tests/test_torch_eval_runner.py`` runs both).  The ``cuda`` points are
still grouped by shape and policy for the progress lines, as the
reference groups them.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import admission, hashing, kway, router, traces
from repro_torch.core.backend import make_backend, resolve_device
from repro_torch.core.hashing import EMPTY
from repro_torch.core.kway import NEG_INF, KWayConfig
from repro_torch.core.policies import (Policy, on_hit_dyn, on_insert_dyn,
                                       victim_scores_dyn)

HASH_SEED = KWayConfig.__dataclass_fields__["seed"].default

# One count per CUDA graph captured for a torch shape group (on the CPU,
# per group replay), so tests can assert "O(shapes), not O(configs)".
_CAPTURE_COUNTS: collections.Counter = collections.Counter()


def capture_counts() -> dict:
    """Captures of the stacked replay step, keyed by group."""
    return dict(_CAPTURE_COUNTS)


def reset_capture_counts() -> None:
    _CAPTURE_COUNTS.clear()


# ---------------------------------------------------------------------------
# sweep grid
# ---------------------------------------------------------------------------

def assoc_shape(assoc: str, capacity: int) -> tuple[int, int, int]:
    """Resolve an associativity descriptor ("k8", "sampled8", "full") to
    (num_sets, ways, sample)."""
    if assoc == "full":
        return 1, capacity, 0
    if assoc.startswith("sampled"):
        return 1, capacity, int(assoc[len("sampled"):])
    if assoc.startswith("k"):
        k = int(assoc[1:])
        if capacity % k:
            raise ValueError(f"capacity {capacity} not divisible by k={k}")
        return capacity // k, k, 0
    raise ValueError(f"unknown associativity descriptor {assoc!r}")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One cell of a hit-ratio grid (a single replay)."""

    family: str
    policy: Policy
    assoc: str                 # "k4" | "sampled8" | "full" | ...
    capacity: int
    backend: str = "torch"
    admission: str = "none"    # "none" | "tinylfu"
    seed: int = 42
    n: int = 60_000

    @property
    def shape(self) -> tuple[int, int, int]:
        return assoc_shape(self.assoc, self.capacity)

    @property
    def record_id(self) -> str:
        """Stable identity for baseline joins (seed-independent)."""
        return (f"{self.family}/{self.policy.name}/{self.assoc}"
                f"/{self.backend}/{self.admission}")


@dataclasses.dataclass(frozen=True)
class HitRatioSpec:
    """A declarative grid; ``expand()`` yields the supported points."""

    families: tuple = ("zipf", "zipf_shift", "scan_loop", "oltp_mix")
    policies: tuple = (Policy.LRU, Policy.LFU, Policy.HYPERBOLIC)
    assoc: tuple = ("k4", "k8", "k32", "sampled8", "full")
    backends: tuple = ("torch",)
    admissions: tuple = ("none",)
    capacity: int = 1024
    n: int = 60_000
    seeds: tuple = (42,)
    # family -> extra kwargs for traces.generate, e.g.
    # {"scan_loop": {"working": 1536, "noise": 0.1}}
    trace_kwargs: dict = dataclasses.field(default_factory=dict)

    def expand(self) -> tuple[list[SweepPoint], list[str]]:
        """-> (points, skipped): skipped lists unsupported combos loudly."""
        points, skipped = [], []
        for fam in self.families:
            for pol in self.policies:
                for assoc in self.assoc:
                    _, k, sample = assoc_shape(assoc, self.capacity)
                    for be in self.backends:
                        reason = _backend_unsupported(be, k, sample)
                        if reason:
                            skipped.append(
                                f"{fam}/{pol.name}/{assoc}/{be}: {reason}")
                            continue
                        for adm in self.admissions:
                            for seed in self.seeds:
                                points.append(SweepPoint(
                                    family=fam, policy=pol, assoc=assoc,
                                    capacity=self.capacity, backend=be,
                                    admission=adm, seed=seed, n=self.n))
        return points, sorted(set(skipped))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["policies"] = [p.name for p in self.policies]
        return d


def _backend_unsupported(backend: str, ways: int,
                         sample: int) -> Optional[str]:
    if backend == "cuda":
        from repro_torch.kernels.kway_probe import MAX_WAYS
        if sample:
            return "cuda backend does not support sampled policies"
        if ways > MAX_WAYS:
            return f"cuda backend requires ways <= {MAX_WAYS}"
    elif backend == "ref":
        return ("ref backend is the sequential Python oracle, not a sweep "
                "substrate (use the golden differential tests)")
    elif backend != "torch":
        return f"unknown backend {backend!r}"
    return None


# ---------------------------------------------------------------------------
# the stacked torch group
#
# State is a stack of per-config caches: keys/meta [C, S, K], one clock for
# all (every lane takes one request a step).  One step replays one request
# per config lane with the sequential backend semantics: get at time
# `clock` (hit -> on_hit metadata), put-on-miss at time `clock + 1` (victim
# scored then), clock += 2.  Every update is in place on the group's
# tensors and no op reads a value back to the host, so a CUDA graph holds
# the step.
# ---------------------------------------------------------------------------

def _victim_way(sample, ways, pidx, policies, keys_row, ma_row, mb_row,
                now):
    """Victim way of each lane's set row [C, K] at logical time ``now``
    (B = 1 semantics of ``kway._victim_order_arrays``: empty ways first,
    the sampled draw when 0 < sample < ways, the first minimum on ties)
    -> int64 [C]."""
    pol = pidx[:, None]
    if 0 < sample < ways:
        way_ids = kway.sampled_way_ids(sample, ways, now)          # [m]
        ks = keys_row[:, way_ids]
        scores = victim_scores_dyn(pol, ma_row[:, way_ids],
                                   mb_row[:, way_ids], now, ks, policies)
        scores = torch.where(ks == EMPTY, torch.full_like(scores, NEG_INF),
                             scores)
        return way_ids[torch.argmin(scores, dim=1)]
    scores = victim_scores_dyn(pol, ma_row, mb_row, now, keys_row, policies)
    scores = torch.where(keys_row == EMPTY,
                         torch.full_like(scores, NEG_INF), scores)
    return torch.argmin(scores, dim=1)


def _sketch_words(cfg, packed, lanes, keys):
    """Per row: the flat word index into ``packed`` [C, ROWS, W/8] of each
    lane's key, and its nibble shift -> int64 [ROWS, C] each."""
    word, shift = admission._positions(cfg, keys)
    rows = torch.arange(admission.ROWS, device=keys.device)[:, None]
    return (lanes[None, :] * admission.ROWS + rows) * packed.shape[2] + word, \
        shift


def _estimate(cfg, packed, door, lanes, keys):
    """``admission.estimate`` of one key per config lane -> int64 [C]."""
    keys = hashing.sanitize_keys(keys)
    flat, shift = _sketch_words(cfg, packed, lanes, keys)
    nib = (hashing.as_u32(packed.reshape(-1)[flat]) >> shift) & 0xF
    dword, dbit = admission._door_pos(cfg, keys)
    d = (hashing.as_u32(door[lanes, dword]) >> dbit) & 1
    return nib.min(dim=0).values + d


def _record(cfg, packed, door, additions, lanes, keys) -> None:
    """``admission.record`` of one enabled lane per config, in place on the
    stacked sketch (packed [C, ROWS, W/8], door [C, DW], additions [C]).
    With one key a sketch, the reference's scatter-set of the door word and
    max-merge of the counter words are plain writes; aging is a
    ``torch.where``."""
    dword, dbit = admission._door_pos(cfg, keys)
    cur_door = hashing.as_u32(door[lanes, dword])
    dmask = torch.ones_like(dbit) << dbit
    in_door = (cur_door & dmask) != 0
    door[lanes, dword] = hashing.to_i32(cur_door | dmask)

    flat, shift = _sketch_words(cfg, packed, lanes, keys)
    pv = packed.view(-1)
    cur = hashing.as_u32(pv[flat])
    inc = in_door[None, :] & (((cur >> shift) & 0xF) < 15)
    pv[flat] = hashing.to_i32(torch.where(
        inc, cur + (torch.ones_like(shift) << shift), cur))

    additions += 1
    aged = additions >= cfg.sample
    halved = hashing.to_i32((hashing.as_u32(packed) >> 1) & 0x77777777)
    packed.copy_(torch.where(aged[:, None, None], halved, packed))
    door.copy_(torch.where(aged[:, None], torch.zeros_like(door), door))
    additions.copy_(torch.where(aged, torch.zeros_like(additions), additions))


class _Group:
    """One stacked replay of same-shape torch points: the state of C caches
    (and sketches), the traces [C, N] and the step over them."""

    def __init__(self, num_sets, ways, sample, hash_seed, tinylfu, pidx,
                 trace_cn: torch.Tensor):
        self.num_sets, self.ways, self.sample = num_sets, ways, sample
        self.hash_seed, self.tinylfu = hash_seed, tinylfu
        self.trace = trace_cn
        dev = trace_cn.device
        c = trace_cn.shape[0]
        self.pidx = pidx
        # the policies the lanes hold: the step evaluates only theirs
        self.policies = tuple(Policy(p) for p in sorted(set(pidx.tolist())))
        self.lanes = torch.arange(c, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.keys = torch.empty((c, num_sets, ways), **i32)
        self.ma = torch.empty_like(self.keys)
        self.mb = torch.empty_like(self.keys)
        self.clock = torch.empty((), **i32)
        self.hits = torch.empty((c,), **i32)
        self.step_idx = torch.empty((1,), dtype=torch.int64, device=dev)
        if tinylfu is not None:
            self.packed = torch.empty((c, admission.ROWS, tinylfu.width // 8),
                                      **i32)
            self.door = torch.empty((c, tinylfu.door_bits // 32), **i32)
            self.additions = torch.empty((c,), **i32)
        self.reset()

    def reset(self) -> None:
        """Empty caches and sketches, the clock at 0, the first request."""
        self.keys.fill_(EMPTY)
        for t in (self.ma, self.mb, self.clock, self.hits, self.step_idx):
            t.zero_()
        if self.tinylfu is not None:
            for t in (self.packed, self.door, self.additions):
                t.zero_()

    def step(self) -> None:
        """One request through every config lane, in place."""
        lanes, pidx, clock = self.lanes, self.pidx, self.clock
        raw = self.trace.index_select(1, self.step_idx)[:, 0]
        qkey = hashing.sanitize_keys(raw)
        s = hashing.set_index(qkey, self.num_sets, self.hash_seed)
        row = self.keys[lanes, s]                                   # [C, K]
        ma_row = self.ma[lanes, s]
        mb_row = self.mb[lanes, s]
        eq = (row == qkey[:, None]) & (row != EMPTY)
        hit = eq.any(dim=1)
        way = eq.to(torch.int8).argmax(dim=1)

        ok = None
        if self.tinylfu is not None:
            # the phase order of the chunked TinyLFU replay: record, peek
            # the victim at time `clock` (pre-get), admission-gate the miss
            tl = self.tinylfu
            _record(tl, self.packed, self.door, self.additions, lanes, qkey)
            vway0 = _victim_way(self.sample, self.ways, pidx, self.policies,
                                row, ma_row, mb_row, clock)
            vkey0 = row[lanes, vway0]
            vvalid = (vkey0 != EMPTY) & ~hit
            ok = (~vvalid) | (
                _estimate(tl, self.packed, self.door, lanes, qkey)
                > _estimate(tl, self.packed, self.door, lanes, vkey0))

        # get phase at time `clock`
        ha, hb = on_hit_dyn(pidx, ma_row[lanes, way], mb_row[lanes, way],
                            clock, self.policies)
        ma_row[lanes, way] = torch.where(hit, ha, ma_row[lanes, way])
        mb_row[lanes, way] = torch.where(hit, hb, mb_row[lanes, way])

        # put phase at time `clock + 1`, miss lanes only, the victim scored
        # on the post-get row
        t_put = clock + 1
        vway = _victim_way(self.sample, self.ways, pidx, self.policies, row,
                           ma_row, mb_row, t_put)
        ia, ib = on_insert_dyn(pidx, t_put, tuple(pidx.shape),
                               policies=self.policies)
        do = ~hit if ok is None else ~hit & ok
        row[lanes, vway] = torch.where(do, qkey, row[lanes, vway])
        ma_row[lanes, vway] = torch.where(do, ia, ma_row[lanes, vway])
        mb_row[lanes, vway] = torch.where(do, ib, mb_row[lanes, vway])

        self.keys[lanes, s] = row
        self.ma[lanes, s] = ma_row
        self.mb[lanes, s] = mb_row
        self.hits += hit.to(torch.int32)
        self.clock += 2
        self.step_idx += 1


def _replay_group_torch(num_sets, ways, sample, hash_seed, tinylfu, pidx,
                        trace_cn: torch.Tensor) -> torch.Tensor:
    """One stacked replay of same-shape torch configs: ``pidx`` int32 [C]
    (policy index per lane), ``trace_cn`` int32 [C, N] key bit patterns on
    the group's device -> hits int32 [C].

    On the card the step is captured once as a CUDA graph (after a warm-up
    step under ``set_sync_debug_mode("error")``, so an op that would read a
    value back to the host raises) and replayed once per request; a step
    that cannot be captured raises.  On the CPU it runs eagerly."""
    gkey = ("torch", num_sets, ways, sample, trace_cn.shape[1],
            tinylfu is not None)
    g = _Group(num_sets, ways, sample, hash_seed, tinylfu, pidx, trace_cn)
    n = trace_cn.shape[1]
    _CAPTURE_COUNTS[gkey] += 1
    if trace_cn.device.type != "cuda":
        for _ in range(n):
            g.step()
        return g.hits
    side = torch.cuda.Stream(trace_cn.device)
    side.wait_stream(torch.cuda.current_stream(trace_cn.device))
    prev = torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            g.step()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.current_stream(trace_cn.device).wait_stream(side)
    g.reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g.step()
    for _ in range(n):
        graph.replay()
    return g.hits


# ---------------------------------------------------------------------------
# sharded replay of grid points
# ---------------------------------------------------------------------------

def replay_sharded_point(point: SweepPoint, shards: int, batch: int = 256,
                         trace: Optional[np.ndarray] = None,
                         device=None) -> float:
    """Hit ratio of one sweep-grid point replayed through the set-sharded
    batched path (``simulate.replay_batched`` with ``shards=D`` on the
    point's backend).  Batched conflict resolution perturbs hit ratios
    slightly against the grid's exact B = 1 replay, so callers gate these
    values against the B = 1 baselines with a small band."""
    from repro_torch.core import simulate

    s, k, sample = point.shape
    cfg = KWayConfig(num_sets=s, ways=k, policy=point.policy, sample=sample)
    tlfu = (admission.for_capacity(point.capacity)
            if point.admission == "tinylfu" else None)
    if trace is None:
        trace = traces.generate(point.family, point.n, seed=point.seed)
    sim = simulate.SimConfig(cache=cfg, tinylfu=tlfu, backend=point.backend,
                             device=device)
    return simulate.replay_batched(sim, trace, batch=batch, shards=shards)


# ---------------------------------------------------------------------------
# running a sweep
# ---------------------------------------------------------------------------

def _trace_cache(points: list[SweepPoint], trace_kwargs: dict) -> dict:
    cache = {}
    for p in points:
        key = (p.family, p.seed, p.n)
        if key not in cache:
            cache[key] = traces.generate(
                p.family, p.n, seed=p.seed, **trace_kwargs.get(p.family, {}))
    return cache


def _replay_cuda_point(p: SweepPoint, tlfu, trace: np.ndarray, dev) -> int:
    """One kernel-3 launch: the ``cuda`` backend's replay of the whole
    trace as ``[N, 1]`` chunks -> hits."""
    s, k, _ = p.shape
    be = make_backend("cuda", KWayConfig(num_sets=s, ways=k, policy=p.policy),
                      dev)
    chunks, enabled = router.pad_chunks(trace, 1)
    hits, _, _, _ = be.replay(be.init(), chunks, enabled, tinylfu=tlfu)
    return int(hits.sum())


def run_hit_ratio_sweep(spec: HitRatioSpec, progress=None, device=None):
    """Execute the grid on ``device`` (None: the card).  Returns (records,
    skipped).

    Each record aggregates one grid cell over ``spec.seeds``:
    ``{"id", config fields, "metric": "hit_ratio", "value": mean,
    "per_seed": [...], "comparable": True}``.
    """
    dev = resolve_device(device)
    points, skipped = spec.expand()
    tr = _trace_cache(points, spec.trace_kwargs)
    tlfu = admission.for_capacity(spec.capacity)

    groups: dict = collections.defaultdict(list)
    for p in points:
        s, k, sample = p.shape
        adm = tlfu if p.admission == "tinylfu" else None
        if p.backend == "cuda":
            gkey = ("cuda", s, k, sample, p.n, adm, p.policy)
        else:
            gkey = ("torch", s, k, sample, p.n, adm)
        groups[gkey].append(p)

    counts_before = collections.Counter(_CAPTURE_COUNTS)
    hit_ratio: dict[SweepPoint, float] = {}
    for gkey, pts in groups.items():
        backend, s, k, sample, n, adm = gkey[:6]
        if progress:
            progress(f"group {backend}/S{s}xK{k}"
                     f"{f'/sample{sample}' if sample else ''} "
                     f"({len(pts)} configs "
                     f"{'stacked' if backend == 'torch' else 'one launch each'})")
        if backend == "cuda":
            for p in pts:
                hit_ratio[p] = _replay_cuda_point(
                    p, adm, tr[(p.family, p.seed, p.n)], dev) / p.n
            continue
        trace_cn = hashing.key_tensor(
            np.stack([tr[(p.family, p.seed, p.n)] for p in pts]), dev)
        pidx = torch.tensor([int(p.policy) for p in pts], dtype=torch.int32,
                            device=dev)
        hits = _replay_group_torch(s, k, sample, HASH_SEED, adm, pidx,
                                   trace_cn)
        for p, h in zip(pts, hits.cpu().numpy()):
            hit_ratio[p] = float(h) / p.n

    # capture economy: the stacked step is captured once per cache shape
    # group, never once per config
    n_torch = sum(1 for g in groups if g[0] == "torch")
    new_captures = sum((collections.Counter(_CAPTURE_COUNTS)
                        - counts_before).values())
    assert new_captures <= n_torch, (
        f"stacked sweep captured {new_captures} replay steps for {n_torch} "
        "shape groups — the step is being captured per config instead of "
        "once per cache shape")

    records = []
    seen = set()
    for p in points:
        if p.record_id in seen:
            continue
        seen.add(p.record_id)
        per_seed = [hit_ratio[dataclasses.replace(p, seed=sd)]
                    for sd in spec.seeds]
        s, k, sample = p.shape
        records.append({
            "id": p.record_id,
            "family": p.family, "policy": p.policy.name, "assoc": p.assoc,
            "num_sets": s, "ways": k, "sample": sample,
            "capacity": p.capacity, "backend": p.backend,
            "admission": p.admission, "n": p.n, "seeds": list(spec.seeds),
            "metric": "hit_ratio",
            "value": float(np.mean(per_seed)),
            "per_seed": per_seed,
            "comparable": True,
        })
    return records, skipped
