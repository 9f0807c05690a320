"""Figure-by-figure reproduction entry points (paper Figs. 1, 4-30).

Counterpart of ``repro/eval/figures.py``: the same twelve figures, specs,
quick and full sizes and record ids, in the port's words (``port_id``:
``jnp`` -> ``torch``, ``pallas`` -> ``cuda``, ``vmem`` -> ``smem``).  Each
function runs one figure family on ``device`` (None: the card) and returns
``(spec_dict, records, skipped)`` ready for ``artifacts.make_artifact``:

  * ``hit_ratio_vs_associativity`` — Figs. 4-13: hit ratio of k in
    {4, 8, 32}, sampled-8 and fully-associative caches per trace family x
    policy (torch groups and one kernel-3 launch per ``cuda`` point).
  * ``sampled_vs_limited``         — the Redis-style sampled-k full cache vs
    the paper's limited-associativity k-way cache at matched k.
  * ``admission_ablation``         — TinyLFU on/off at k=8 (paper §5.2).
  * ``throughput_vs_batch``        — Figs. 14-26 analogue: batch size stands
    in for thread count; layouts, backends and the sharded layer.
  * ``throughput_resident``        — kernel 3's whole-trace replay vs the
    chunked path, plus bit-identity hit-ratio records.
  * ``throughput_vs_shards``       — shards stand in for threads.
  * ``showdown``                   — Fig. 1 analogue: req/s of host caches
    under threads next to our batched/resident device paths.
  * ``synthetic_mix``              — Figs. 27-30: fixed hit-rate workloads.
  * ``serving``                    — end-to-end prefix-cache serving rows.
  * ``serving_engine``             — host loop vs the device-resident tick.
  * ``robustness``                 — validator, scrub, ladder, TTL, overhead.
  * ``hierarchy``                  — the L1-over-L2 hierarchy (kernel 4).

Hit-ratio figures run on the stacked sweep runner; throughput figures are
wall-clock timed per configuration (``eval/timing.py`` blocks on every
CUDA result) and marked non-comparable.  The reference's backends default
to ``jnp``; the port's ``SimConfig`` and ``ShardedConfig`` default to
``cuda``, so every figure names its backend where the reference relied on
its default: ``torch`` wherever a record id or field says ``jnp``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.backend import resolve_device
from repro_torch.core.policies import Policy
from repro_torch.eval import runner
from repro_torch.eval.runner import HitRatioSpec
from repro_torch.eval.timing import (block, time_chained_percentiles,
                                     time_host, time_jitted,
                                     time_jitted_percentiles,
                                     time_replay_percentiles)

QUICK_N = 6_000
FULL_N = 60_000


def _run(spec: HitRatioSpec, progress=None, device=None):
    records, skipped = runner.run_hit_ratio_sweep(spec, progress=progress,
                                                  device=device)
    return spec.to_dict(), records, skipped


def hit_ratio_vs_associativity(quick: bool = False, progress=None,
                               backends=("torch", "cuda"), device=None):
    """Paper Figs. 4-13: the k=8 line sits on the fully-associative line.
    ``cuda`` points are one kernel-3 launch each; sampled shapes and more
    than 128 ways are skipped on ``cuda`` with the reference's reasons."""
    spec = HitRatioSpec(
        families=("zipf", "zipf_shift", "scan_loop", "oltp_mix")
        if quick else ("zipf", "zipf_shift", "scan_loop", "oltp_mix",
                       "recency"),
        policies=(Policy.LRU, Policy.LFU, Policy.HYPERBOLIC),
        assoc=("k4", "k8", "k32", "sampled8", "full"),
        backends=tuple(backends),
        capacity=1024,
        n=QUICK_N if quick else FULL_N,
        seeds=(42,) if quick else (42, 43, 44),
    )
    return _run(spec, progress, device)


def sampled_vs_limited(quick: bool = False, progress=None, device=None):
    """Sampled-k full-associativity (Redis style) vs limited-associativity
    k-way at matched k — the paper's 'sampling is the wrong shortcut' plot."""
    spec = HitRatioSpec(
        families=("zipf", "scan_loop", "oltp_mix", "recency"),
        policies=(Policy.LRU, Policy.LFU),
        assoc=("k4", "sampled4", "k8", "sampled8", "k16", "sampled16",
               "full"),
        backends=("torch",),
        capacity=1024,
        n=QUICK_N if quick else FULL_N,
        seeds=(42,) if quick else (42, 43, 44),
    )
    return _run(spec, progress, device)


def admission_ablation(quick: bool = False, progress=None,
                       admissions=("none", "tinylfu"), device=None):
    """TinyLFU admission on/off at k=8 (the paper pairs it with LFU)."""
    spec = HitRatioSpec(
        families=("zipf", "zipf_shift", "scan_loop", "oltp_mix"),
        policies=(Policy.LRU, Policy.LFU, Policy.HYPERBOLIC),
        assoc=("k8",),
        backends=("torch",),
        admissions=tuple(admissions),
        capacity=1024,
        n=QUICK_N if quick else FULL_N,
        seeds=(42,) if quick else (42, 43, 44),
    )
    return _run(spec, progress, device)


# ---------------------------------------------------------------------------
# throughput figures (wall-clock; non-comparable in artifacts)
# ---------------------------------------------------------------------------

THROUGHPUT_CAPACITY = 4096


def _throughput_impls(policy):
    from repro_torch.core.kway import KWayConfig, fully_associative
    return {
        "kway-soa": KWayConfig(num_sets=THROUGHPUT_CAPACITY // 8, ways=8,
                               policy=policy, layout="soa"),
        "kway-aos": KWayConfig(num_sets=THROUGHPUT_CAPACITY // 8, ways=8,
                               policy=policy, layout="aos"),
        "sampled": KWayConfig(num_sets=THROUGHPUT_CAPACITY // 128, ways=128,
                              policy=policy, sample=8),
        "full": fully_associative(THROUGHPUT_CAPACITY, policy),
    }


def _tp_record(name: str, batch: int, mops: float, **extra) -> dict:
    rec = {"id": f"{name}/batch{batch}", "impl": name, "batch": batch,
           "metric": "mops_per_s", "value": round(mops, 3),
           "comparable": False}
    rec.update(extra)
    return rec


def throughput_vs_batch(quick: bool = False, progress=None,
                        backends=("torch", "cuda", "ref"), shards=(1, 4),
                        device=None):
    """Paper Figs. 14-26 analogue: ops/sec vs batch size (thread analogue)
    across layouts, the CacheBackend substrates, and the sharded layer.

    Where the port differs: it has no buffer-donating access (its
    functions return new tensors), so the reference's
    ``backend-jnp-fused-donated`` rows become ``skipped`` entries for
    ``backend-torch-fused-donated`` and the sharded rows' ``ShardedConfig``
    has no ``donate``; the sharded rows run the ``torch`` backend (the
    reference's default); ``cuda`` takes every batch (the reference keeps
    ``pallas`` to B <= 256 because interpret mode compiles slowly).  The
    ``backend-cuda-{fused,twophase}`` rows launch kernels 2 and 1 per call,
    the ``replay-*-cuda`` rows the chunked path and kernel 3."""
    from repro_torch.core import hashing, kway, traces
    from repro_torch.core.backend import make_backend
    from repro_torch.core.sharded import ShardedCache, ShardedConfig

    dev = resolve_device(device)
    batches = (64, 256) if quick else (64, 256, 1024)
    policy = Policy.LRU
    n_warm = 20_480
    tr = traces.generate("zipf", n_warm + 4096, seed=7, catalog=1 << 14)
    records, skipped = [], []

    def keys_of(a):
        k = hashing.key_tensor(a, dev)
        return k, k

    def warm(cfg):
        state = kway.make_cache(cfg, device=dev)
        for chunk in tr[:n_warm].reshape(-1, 512):
            state, *_ = kway.access(cfg, state, *keys_of(chunk))
        return state

    soa_state = None
    for name, cfg in _throughput_impls(policy).items():
        if progress:
            progress(f"throughput impl {name}")
        state = warm(cfg)
        if name == "kway-soa":
            soa_state = state
        for b in batches:
            keys, vals = keys_of(tr[n_warm:n_warm + b])
            dt = time_jitted(lambda s, k, v, _c=cfg: kway.access(_c, s, k, v)[0],
                             state, keys, vals)
            records.append(_tp_record(name, b, b / dt / 1e6))

    # unified backend layer: fused single-probe access vs the two-phase
    # get-then-put oracle, per backend, p50/p90 steady-state per repetition
    cfg = _throughput_impls(policy)["kway-soa"]
    state = soa_state if soa_state is not None else warm(cfg)
    for bname in backends:
        if progress:
            progress(f"throughput backend {bname}")
        be = make_backend(bname, cfg, dev)
        bl = {"ref": (64,)}.get(bname, batches)
        for b in bl:
            keys, vals = keys_of(tr[n_warm:n_warm + b])
            if bname == "ref":
                # the sequential oracle has no fused path; one two-phase row
                dt = time_host(be.access, state, keys, vals)
                records.append(_tp_record("backend-ref-twophase", b,
                                          b / dt / 1e6))
                continue
            p50 = {}
            for vname, acc in (("fused", be.access),
                               ("twophase", be.access_two_phase)):
                st = time_jitted_percentiles(
                    lambda s, k, v, _a=acc: _a(s, k, v)[0], state, keys, vals)
                p50[vname] = st["p50"]
                records.append(_tp_record(
                    f"backend-{bname}-{vname}", b, b / st["p50"] / 1e6,
                    p90_mops=round(b / st["p90"] / 1e6, 3),
                    p50_req_s=round(b / st["p50"], 1),
                    p90_req_s=round(b / st["p90"], 1)))
            records.append(_tp_record(
                f"backend-{bname}-fused-speedup", b,
                p50["twophase"] / p50["fused"], metric="speedup_x"))
        if bname == "torch":
            skipped.extend(
                f"backend-torch-fused-donated/batch{b}: the port has no "
                "donating access (its functions return new tensors)"
                for b in bl)

    # set-sharded execution: 1 shard vs N shards (fused access, every chunk
    # rebinds the returned state)
    b = max(batches)
    for ns in shards:
        if progress:
            progress(f"throughput sharded x{ns}")
        sc = ShardedCache(ShardedConfig(cache=cfg, num_shards=ns,
                                        backend="torch"), device=dev)
        st = sc.init()
        chunk0 = np.asarray(tr[:b], np.uint32)
        for _ in range(3):  # warm the allocator + shard states
            st, *_ = sc.access(st, chunk0, chunk0.astype(np.int32))

        def run_chunks(n_chunks):
            nonlocal st
            for i in range(n_chunks):
                off = n_warm + (i * b) % 4096
                chunk = np.asarray(tr[off:off + b], np.uint32)
                if len(chunk) < b:
                    chunk = chunk0
                st, *_ = sc.access(st, chunk, chunk.astype(np.int32))
            # block so the timed region covers the execution, not just
            # the asynchronous launches
            block(st)

        n_chunks = 10
        dt = time_host(run_chunks, n_chunks, iters=1) / n_chunks
        records.append(_tp_record(f"sharded-{ns}shard", b, b / dt / 1e6))

    # kernel 3's trace-resident replay vs the chunked-scan replay on the
    # kernel path (headline rows; the full sweep + bit-identity records
    # live in throughput_resident)
    if "cuda" in backends:
        from repro_torch.core.simulate import SimConfig, replay_batched
        n_rep, b_rep = 16_384, 256
        tr_rep = tr[:n_rep]
        sim = SimConfig(cache=cfg, backend="cuda", device=dev)
        rp50 = {}
        for mode, resident in (("scan", False), ("resident", True)):
            if progress:
                progress(f"replay {mode} cuda")
            st = time_replay_percentiles(
                lambda _r=resident: replay_batched(sim, tr_rep, batch=b_rep,
                                                   resident=_r),
                iters=3)
            rp50[mode] = st["p50"]
            records.append(_tp_record(
                f"replay-{mode}-cuda", b_rep, n_rep / st["p50"] / 1e6,
                n=n_rep, p50_req_s=round(n_rep / st["p50"], 1),
                p90_req_s=round(n_rep / st["p90"], 1),
                reps_discarded=st["reps_discarded"]))
        records.append(_tp_record(
            "replay-resident-speedup-cuda", b_rep,
            rp50["scan"] / rp50["resident"], metric="speedup_x"))

    spec = {"quick": quick, "batches": list(batches),
            "policy": policy.name, "backends": list(backends),
            "shards": list(shards), "capacity": THROUGHPUT_CAPACITY}
    return spec, records, skipped


def throughput_resident(quick: bool = False, progress=None,
                        backends=("torch", "cuda"), device=None):
    """Kernel 3's trace-resident replay vs the chunked replay: whole-trace
    replay req/s, p50/p90 steady-state.

    Rows per backend: ``replay-scan-{b}`` (the chunked loop; on ``cuda``
    kernel 2 and the torch apply per chunk), ``replay-resident-{b}``
    (``CacheBackend.replay``: on ``cuda`` kernel 3, ONE launch for the whole
    trace; on ``torch`` the chunked loop, the comparison anchor) and
    ``replay-resident-speedup-{b}``.

    Plus comparable ``resident-eq/...`` hit-ratio records over a small
    (family x policy x +-TinyLFU) grid: ``value`` is the resident hit ratio
    and ``scan_value`` the chunked one — the two must be EXACTLY equal
    (tol 0.0; kernel 3 is bit-identical to the chunked path)."""
    from repro_torch.core import admission, traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.simulate import SimConfig, replay_batched

    dev = resolve_device(device)
    policy = Policy.LRU
    batch = 256
    n = 16_384 if quick else 65_536
    kcfg = KWayConfig(num_sets=THROUGHPUT_CAPACITY // 8, ways=8,
                      policy=policy)
    tr = traces.generate("zipf", n, seed=7, catalog=1 << 14)
    records = []
    p50 = {}
    for bname in backends:
        sim = SimConfig(cache=kcfg, backend=bname, device=dev)
        for mode, resident in (("scan", False), ("resident", True)):
            if progress:
                progress(f"replay {mode} {bname}")
            st = time_replay_percentiles(
                lambda _r=resident: replay_batched(sim, tr, batch=batch,
                                                   resident=_r),
                iters=3 if quick else 5)
            p50[(bname, mode)] = st["p50"]
            records.append(_tp_record(
                f"replay-{mode}-{bname}", batch, n / st["p50"] / 1e6,
                n=n, mode=mode, backend=bname,
                p50_req_s=round(n / st["p50"], 1),
                p90_req_s=round(n / st["p90"], 1),
                reps_discarded=st["reps_discarded"]))
        records.append(_tp_record(
            f"replay-resident-speedup-{bname}", batch,
            p50[(bname, "scan")] / p50[(bname, "resident")],
            metric="speedup_x", backend=bname))

    # bit-identity records: resident (kernel 3) vs chunked scan
    n_eq = QUICK_N if quick else FULL_N
    eq_backend = "cuda" if "cuda" in backends else backends[0]
    tlfu = admission.for_capacity(1024)
    for family in ("zipf", "scan_loop"):
        tre = traces.generate(family, n_eq, seed=42)
        for pol in (Policy.LRU, Policy.LFU):
            for adm in ("none", "tinylfu"):
                if progress:
                    progress(f"resident-eq {family}/{pol.name}/{adm}")
                cfg = KWayConfig(num_sets=128, ways=8, policy=pol)
                sim = SimConfig(cache=cfg, backend=eq_backend, device=dev,
                                tinylfu=tlfu if adm == "tinylfu" else None)
                hr_res = replay_batched(sim, tre, batch=batch, resident=True)
                hr_scan = replay_batched(sim, tre, batch=batch,
                                         resident=False)
                records.append({
                    "id": f"resident-eq/{family}/{pol.name}/{adm}",
                    "family": family, "policy": pol.name,
                    "admission": adm, "backend": eq_backend,
                    "batch": batch, "n": n_eq, "capacity": 1024,
                    "metric": "hit_ratio", "value": hr_res,
                    "scan_value": hr_scan,
                    "comparable": True, "tol": 0.0,
                })
    spec = {"quick": quick, "backends": list(backends), "batch": batch,
            "n": n, "n_eq": n_eq, "policy": policy.name,
            "capacity": THROUGHPUT_CAPACITY}
    return spec, records, []


def throughput_vs_shards(quick: bool = False, progress=None,
                         shards=(1, 2, 4, 8), device=None):
    """The paper's threads-vs-throughput plot (Figs. 14-26 headline), with
    set shards standing in for threads: each shard brings its own fixed-size
    request stream per serving tick, so the offered load per tick is ``D x
    tick_batch``.

    Rows per shard count (``torch`` backend, as the reference's ``jnp``;
    LRU, k=8): ``sharded-torch-shard{D}`` (p50/p90 req/s of the routed
    serving tick, the shard states rebound every tick: the port has no
    donation), ``scan-shard{D}`` (``ShardedCache.replay`` of the whole
    trace, one host sync at the end) and ``scaling-shard{D}`` (tick p50
    speedup over shard1).

    Plus comparable hit-ratio records for shards in {1, 4} on a slice of
    the baseline grid (``{family}/{policy}/k8/torch/shard{D}``, tol 0.02
    against the B=1 grid: batched replay tracks it within a small band)."""
    from repro_torch.core import traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.sharded import ShardedCache, ShardedConfig
    from repro_torch.eval.runner import SweepPoint, replay_sharded_point

    dev = resolve_device(device)
    policy = Policy.LRU
    kcfg = KWayConfig(num_sets=THROUGHPUT_CAPACITY // 8, ways=8,
                      policy=policy)
    tick_batch = 32                      # per-shard per-tick lane budget
    n_scan = 65_536 if quick else 262_144
    tr = traces.generate("zipf", n_scan, seed=7, catalog=1 << 14)
    records = []
    tick_p50 = {}

    for d in shards:
        if progress:
            progress(f"shards={d} (tick + scan)")
        bg = d * tick_batch
        sc = ShardedCache(ShardedConfig(cache=kcfg, num_shards=d,
                                        backend="torch"), device=dev)
        offs = [(i * bg) % (n_scan - bg) for i in range(64)]
        it = {"i": 0, "state": sc.init()}

        def tick():
            chunk = tr[offs[it["i"] % len(offs)]:][:bg]
            it["i"] += 1
            st2, hit, *_ = sc.access(it["state"], chunk,
                                     chunk.astype(np.int32))
            it["state"] = st2
            return hit

        stats = time_chained_percentiles(tick)
        tick_p50[d] = bg / stats["p50"]
        records.append(_tp_record(
            f"sharded-torch-shard{d}", bg, bg / stats["p50"] / 1e6,
            shards=d, per_shard_batch=tick_batch,
            p90_mops=round(bg / stats["p90"] / 1e6, 3),
            p50_req_s=round(bg / stats["p50"], 1),
            p90_req_s=round(bg / stats["p90"], 1)))

        # no-host-sync row: the whole trace in one call, one sync at the end
        rstats = time_replay_percentiles(
            lambda: sc.replay(tr, bg), iters=3 if quick else 5)
        records.append(_tp_record(
            f"scan-shard{d}", bg, n_scan / rstats["p50"] / 1e6,
            shards=d, host_syncs_per_replay=1, n=n_scan,
            p50_req_s=round(n_scan / rstats["p50"], 1),
            p90_req_s=round(n_scan / rstats["p90"], 1)))

    for d in shards:
        records.append(_tp_record(
            f"scaling-shard{d}", d * tick_batch,
            tick_p50[d] / tick_p50[shards[0]], metric="speedup_x",
            shards=d))

    # comparable hit-ratio rows: the sharded batched replay vs the B=1 grid
    n_hr = QUICK_N if quick else FULL_N
    for d in (1, 4):
        for family in ("zipf", "scan_loop"):
            for pol in (Policy.LRU, Policy.LFU):
                if progress:
                    progress(f"hit-ratio {family}/{pol.name}/shard{d}")
                p = SweepPoint(family=family, policy=pol, assoc="k8",
                               capacity=1024, n=n_hr)
                hr = replay_sharded_point(p, shards=d, batch=256,
                                          device=dev)
                records.append({
                    "id": f"{family}/{pol.name}/k8/torch/shard{d}",
                    "family": family, "policy": pol.name, "assoc": "k8",
                    "shards": d, "batch": 256, "n": n_hr,
                    "capacity": p.capacity, "seed": p.seed,
                    "metric": "hit_ratio", "value": hr,
                    "comparable": True, "tol": 0.02,
                })

    spec = {"quick": quick, "shards": list(shards),
            "tick_batch": tick_batch, "n_scan": n_scan,
            "policy": policy.name, "capacity": THROUGHPUT_CAPACITY,
            "backend": "torch"}
    return spec, records, []


def showdown(quick: bool = False, progress=None, threads=(1, 2, 4, 8),
             families=("zipf", "oltp_mix", "lirs_two_pools"),
             policies=("lru", "lfu"), device=None):
    """The paper's Fig. 1 analogue: req/s vs thread count, host caches next
    to our batched/resident device paths.

    External rows, per family x policy and thread count:
    ``cachetools-{policy}/threads{T}`` (``cachetools`` behind the
    documented global lock) and ``striped-{policy}/threads{T}`` (the
    lock-striped pure-Python k-way cache).  Our rows (same trace, same
    capacity, k=8): ``torch-batched-{policy}/batch{B}`` (the chunked torch
    replay) and ``cuda-resident-{policy}/batch{B}`` (kernel 3, ONE launch).

    The gateable output is ``showdown-hr/...``: deterministic
    single-threaded hit ratios per library, ``comparable: true``.  Without
    ``cachetools`` installed its timing rows and its ``showdown-hr/*/
    cachetools`` records go into ``skipped`` ("cachetools is not
    installed") and are not emitted."""
    from repro_torch.core import trace_io, traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.simulate import SimConfig, replay_batched
    from repro_torch.showdown import (HAVE_CACHETOOLS, make_baseline,
                                      replay_threaded)
    from repro_torch.showdown import hit_ratio as baseline_hit_ratio

    dev = resolve_device(device)
    capacity, ways, batch, seed = THROUGHPUT_CAPACITY, 8, 256, 7
    n = 8_192 if quick else 65_536
    iters = 2 if quick else 5
    trace_io.register_fixture_traces()   # lirs_two_pools rides as a family
    pol_enum = {"lru": Policy.LRU, "lfu": Policy.LFU}
    libs = ("cachetools", "striped") if HAVE_CACHETOOLS else ("striped",)
    missing = "cachetools is not installed"
    records, skipped = [], []
    trace_fp = {}

    def rec(rid, value, **extra):
        r = {"id": rid, "metric": "req_per_s", "value": round(value, 1),
             "capacity": capacity, "n": n, "comparable": False}
        r.update(extra)
        records.append(r)

    for family in families:
        tr = traces.generate(family, n, seed=seed)
        trace_fp[family] = trace_io.trace_fingerprint(tr)
        for policy in policies:
            # -- host libraries under threads -----------------------------
            if not HAVE_CACHETOOLS:
                skipped.extend(
                    f"showdown/{family}/cachetools-{policy}/threads{t}: "
                    f"{missing}" for t in threads)
            for lib in libs:
                for t in threads:
                    if progress:
                        progress(f"{family}/{lib}-{policy} threads={t}")
                    cache = make_baseline(lib, capacity, policy, ways=ways)
                    st = replay_threaded(cache, tr, t, iters=iters)
                    rec(f"showdown/{family}/{lib}-{policy}/threads{t}",
                        st["req_s_p50"], family=family, lib=lib,
                        policy=policy, threads=t,
                        p90_req_s=round(st["req_s_p90"], 1),
                        reps_discarded=st["reps_discarded"])

            # -- our device paths (same trace, same capacity, k=8) --------
            kcfg = KWayConfig(num_sets=capacity // ways, ways=ways,
                              policy=pol_enum[policy])
            ours = (("torch-batched", "torch", False),
                    ("cuda-resident", "cuda", True))
            hr_ours = {}
            for name, backend, resident in ours:
                if progress:
                    progress(f"{family}/{name}-{policy}")
                sim = SimConfig(cache=kcfg, backend=backend, device=dev)
                hr_ours[name] = replay_batched(sim, tr, batch=batch,
                                               resident=resident)  # + warm
                st = time_replay_percentiles(
                    lambda sim=sim, r=resident: replay_batched(
                        sim, tr, batch=batch, resident=r),
                    iters=iters, warmup=1)
                rec(f"showdown/{family}/{name}-{policy}/batch{batch}",
                    n / st["p50"], family=family, lib=name, policy=policy,
                    batch=batch, p90_req_s=round(n / st["p90"], 1),
                    reps_discarded=st["reps_discarded"])

            # -- deterministic hit-ratio parity records (the gated rows) --
            hr = {}
            if HAVE_CACHETOOLS:
                hr["cachetools"] = baseline_hit_ratio(
                    make_baseline("cachetools", capacity, policy), tr)
            else:
                skipped.append(
                    f"showdown-hr/{family}/{policy}/cachetools: {missing}")
            hr["striped"] = baseline_hit_ratio(
                make_baseline("striped", capacity, policy, ways=ways), tr)
            hr.update(hr_ours)
            for lib, value in hr.items():
                records.append({
                    "id": f"showdown-hr/{family}/{policy}/{lib}",
                    "family": family, "policy": policy, "lib": lib,
                    "capacity": capacity, "n": n, "seed": seed,
                    "batch": batch if lib.startswith(("torch", "cuda"))
                    else None,
                    "metric": "hit_ratio", "value": round(float(value), 6),
                    "comparable": True, "tol": 1e-6,
                })

    spec = {"quick": quick, "families": list(families),
            "policies": list(policies), "threads": list(threads),
            "capacity": capacity, "ways": ways, "batch": batch,
            "n": n, "seed": seed, "trace_fingerprints": trace_fp}
    return spec, records, skipped


def synthetic_mix(quick: bool = False, progress=None, kinds=None,
                  device=None):
    """Paper Figs. 27-30: fixed-hit-rate workloads per implementation."""
    from repro_torch.core import hashing, kway
    from repro_torch.core.kway import KWayConfig, fully_associative

    dev = resolve_device(device)
    if kinds is None:
        kinds = (("miss100", "hit95") if quick
                 else ("miss100", "hit100", "hit95", "hit90"))
    capacity, batch = 4096, 512
    rng = np.random.default_rng(11)

    def mk_stream(kind, n):
        if kind == "miss100":   # every key unique
            return rng.permutation(np.arange(n, dtype=np.uint32) + (1 << 20))
        resident = rng.integers(0, capacity // 2, n).astype(np.uint32)
        if kind == "hit100":
            return resident
        p_miss = {"hit95": 0.05, "hit90": 0.10}[kind]
        miss = np.arange(n, dtype=np.uint32) + (1 << 20)
        take_miss = rng.random(n) < p_miss
        return np.where(take_miss, miss, resident).astype(np.uint32)

    impls = {
        "kway-soa": KWayConfig(num_sets=capacity // 8, ways=8,
                               policy=Policy.LRU),
        "sampled": KWayConfig(num_sets=capacity // 128, ways=128,
                              policy=Policy.LRU, sample=8),
        "full": fully_associative(capacity, Policy.LRU),
    }
    records = []
    for kind in kinds:
        if progress:
            progress(f"synthetic_mix {kind}")
        stream = mk_stream(kind, batch)
        for name, cfg in impls.items():
            state = kway.make_cache(cfg, device=dev)
            resident = hashing.key_tensor(
                rng.integers(0, capacity // 2, capacity).astype(np.uint32),
                dev)
            for chunk in resident.reshape(-1, 512):
                state, *_ = kway.access(cfg, state, chunk, chunk)
            keys = hashing.key_tensor(stream, dev)
            dt = time_jitted(
                lambda s, k, _c=cfg: kway.access(_c, s, k, k)[0], state, keys)
            records.append(_tp_record(f"{kind}/{name}", batch,
                                      batch / dt / 1e6))
    spec = {"quick": quick, "kinds": list(kinds), "capacity": capacity,
            "batch": batch}
    return spec, records, []


def _smoke_model(dev):
    """The serving figures' model: deepseek-7b's smoke config with the
    port's random weights from seed 0 (not the reference's
    ``jax.random.key(0)`` draw, so generated tokens are the port's own)."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get("deepseek-7b").smoke
    return cfg, lm.init_params(cfg, 0, device=dev)


def serving(quick: bool = False, progress=None, requests=None, prefix_len=48,
            device=None):
    """End-to-end prefix-cache serving (host loop, kernel 5 on the card):
    tok/s, hit ratio, evictions.  The model's weights are the port's own
    draw (``lm.init_params(cfg, 0)``)."""
    import time as _time

    from repro_torch.serve.engine import Engine, EngineConfig

    dev = resolve_device(device)
    if requests is None:
        requests = 6 if quick else 12
    cfg, params = _smoke_model(dev)
    rng = np.random.default_rng(1)
    shared = rng.integers(2, 400, prefix_len)
    prompts = [np.concatenate([shared, rng.integers(2, 400, 8)])
               for _ in range(requests)]
    records = []
    for policy in (Policy.LRU, Policy.LFU):
        if progress:
            progress(f"serving {policy.name}")
        eng = Engine(cfg, params, EngineConfig(
            page=8, num_sets=32, ways=8, policy=policy, max_batch=4,
            max_seq=256, private_pages=128, backend="torch"), device=dev)
        t0 = _time.time()
        for pr in prompts:
            eng.submit(pr, max_new=8)
        fin = eng.run()
        dt = _time.time() - t0
        toks = sum(len(r.generated) for r in fin.values())
        records.append({
            "id": f"{policy.name}/tok_per_s", "policy": policy.name,
            "metric": "tok_per_s", "value": round(toks / dt, 1),
            "comparable": False})
        records.append({
            "id": f"{policy.name}/prefix_hit_ratio", "policy": policy.name,
            "metric": "prefix_hit_ratio", "value": round(eng.hit_ratio(), 3),
            "comparable": True, "tol": 0.02})
        records.append({
            "id": f"{policy.name}/evictions", "policy": policy.name,
            "metric": "evictions", "value": int(eng.stats["evictions"]),
            "comparable": False})
    spec = {"quick": quick, "requests": requests, "prefix_len": prefix_len,
            "model": "deepseek-7b/smoke"}
    return spec, records, []


def serving_engine(quick: bool = False, progress=None, slots=None,
                   requests=None, max_new=4, decode_block=4, device=None):
    """Device-resident serving tick (``jitted=True``: CUDA graphs on the
    card) vs the host-loop engine: p50/p90 requests/s and tok/s over a
    shared-prefix continuous-batching workload, each sample a FRESH engine
    serving the whole request mix (graph capture inside the sample, as the
    reference's compiles are; the discarded warm-up builds the kernels).
    Plus parity rows (comparable, tol 0): emitted tokens equal and the same
    prefix hit ratio between the two engines.  The model's weights are the
    port's own draw (``lm.init_params(cfg, 0)``), so its tokens are the
    port's own."""
    from repro_torch.serve.engine import Engine, EngineConfig

    dev = resolve_device(device)
    if slots is None:
        slots = (32,) if quick else (8, 32)
    if requests is None:
        requests = 128 if quick else 192
    cfg, params = _smoke_model(dev)
    rng = np.random.default_rng(1)
    shared = rng.integers(2, cfg.vocab_size - 1, 48)
    prompts = [np.concatenate([shared,
                               rng.integers(2, cfg.vocab_size - 1,
                                            int(rng.integers(4, 16)))])
               for _ in range(requests)]

    def serve_all(s, jitted):
        eng = Engine(cfg, params, EngineConfig(
            page=8, num_sets=64, ways=8, max_batch=s, max_seq=256,
            private_pages=512, max_prompt=128, decode_block=decode_block,
            jitted=jitted, backend="torch"), device=dev)
        for pr in prompts:
            eng.submit(pr, max_new=max_new)
        fin = eng.run()
        return eng, fin

    records = []
    for s in slots:
        stats, toks, gen = {}, {}, {}
        for jitted in (False, True):
            mode = "jitted" if jitted else "hostloop"
            if progress:
                progress(f"engine-{mode}-slots{s}")
            eng, fin = serve_all(s, jitted)      # parity + token count run
            gen[mode] = ({rid: list(r.generated) for rid, r in fin.items()},
                         eng.hit_ratio())
            toks[mode] = sum(len(r.generated) for r in fin.values())
            stats[mode] = time_replay_percentiles(
                lambda jitted=jitted: serve_all(s, jitted),
                iters=3 if quick else 5, warmup=1)
            records.append({
                "id": f"engine-{mode}-slots{s}/req_per_s",
                "impl": f"engine-{mode}", "slots": s,
                "requests": requests, "max_new": max_new,
                "metric": "req_per_s",
                "value": round(requests / stats[mode]["p50"], 1),
                "p90_req_s": round(requests / stats[mode]["p90"], 1),
                "tok_per_s": round(toks[mode] / stats[mode]["p50"], 1),
                "comparable": False})
        records.append({
            "id": f"engine-jitted-speedup-slots{s}",
            "slots": s, "metric": "speedup_x",
            "value": round(stats["hostloop"]["p50"] / stats["jitted"]["p50"],
                           2),
            "comparable": False})
        records.append({
            "id": f"engine-parity-slots{s}/tokens_equal",
            "slots": s, "metric": "tokens_equal",
            "value": float(gen["hostloop"][0] == gen["jitted"][0]),
            "comparable": True, "tol": 0.0})
        records.append({
            "id": f"engine-parity-slots{s}/hit_ratio",
            "slots": s, "metric": "prefix_hit_ratio",
            "value": round(gen["jitted"][1], 6),
            "scan_value": round(gen["hostloop"][1], 6),
            "comparable": True, "tol": 0.0})
    spec = {"quick": quick, "slots": list(slots), "requests": requests,
            "max_new": max_new, "decode_block": decode_block,
            "prefix_len": 48, "model": "deepseek-7b/smoke"}
    return spec, records, []


def robustness(quick: bool = False, progress=None, ttl: bool = False,
               device=None):
    """Validator coverage, recovery cost, ladder observability and
    validator overhead (``ttl=True`` adds the expiry lane's records).

      * ``robust-clean/{policy}/{backend}/violations`` — the invariant
        validator over the final state of the golden 512-request zipf
        trace, all 5 policies on ``torch`` and ``cuda`` (kernel 3) and the
        sequential ``ref`` oracle on LRU (every policy in full mode).
        Pinned at 0.0, tol 0.
      * ``robust-scrub/{site}/...`` — one seeded bit-flip at the replay
        midpoint, scrub, replay on: the recovered hit ratio and the
        forced-eviction tally.
      * ``robust-ladder/smem-breach/...`` — ``resilient_replay`` under
        ``smem_budget(0)`` (the reference's ``vmem_budget(0)``): it lands
        on ``cuda-scan``, index 2 of the port's ``RUNGS`` as
        ``pallas-scan`` is of the reference's, with the clean hit count.
      * ``robust-overhead/validated-replay/pct`` — wall cost of the
        validator inside the replay loop (``comparable: false``).
      * ``robust-ttl/...`` (``ttl=True``) — TTL replay clean on ``torch``
        and ``cuda``, backend hit parity, and the expiry-scrub chaos loop.
    """
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import trace_io, traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.router import pad_chunks
    from repro_torch.robust import check_cache, events, faults, resilient_replay
    from repro_torch.robust.ladder import RUNGS
    from repro_torch.robust.recovery import scrub, validated_replay

    dev = resolve_device(device)
    num_sets, ways, batch, seed = 16, 4, 8, 2026
    # the golden-trace recipe (tests/test_golden_trace.py)
    tr = traces.generate("zipf", 512, seed=seed, catalog=96)
    tr[::13] = 0
    chunks, enabled = pad_chunks(tr, batch)
    n = int(len(tr))
    records = []
    policies = {"lru": Policy.LRU, "lfu": Policy.LFU, "fifo": Policy.FIFO,
                "random": Policy.RANDOM, "hyperbolic": Policy.HYPERBOLIC}

    def cfg_for(pol):
        return KWayConfig(num_sets=num_sets, ways=ways, policy=pol)

    def violations(cfg, st) -> float:
        return float(int((check_cache(cfg, st, vals_mode="key").lane_bits
                          != 0).sum()))

    def make(name, cfg):
        return backend_mod.make_backend(name, cfg, dev)

    # ---- clean validator: zero false positives -------------------------
    for pname, pol in policies.items():
        cfg = cfg_for(pol)
        for backend in ("torch", "cuda"):
            if progress:
                progress(f"clean {pname}/{backend}")
            be = make(backend, cfg)
            _, _, st, _ = be.replay(be.init(), chunks, enabled)
            records.append({
                "id": f"robust-clean/{pname}/{backend}/violations",
                "policy": pname, "backend": backend, "n": n,
                "metric": "violating_lanes", "value": violations(cfg, st),
                "comparable": True, "tol": 0.0})
        ref_policies = ("lru",) if quick else tuple(policies)
        if pname in ref_policies:
            if progress:
                progress(f"clean {pname}/ref")
            be = make("ref", cfg)
            st = be.init()
            for i in range(chunks.shape[0]):
                keys_i = np.asarray(chunks[i], np.uint32)
                st, _, _, _, _ = be.access(
                    st, keys_i, keys_i.astype(np.int32),
                    enabled=np.asarray(enabled[i]))
            records.append({
                "id": f"robust-clean/{pname}/ref/violations",
                "policy": pname, "backend": "ref", "n": n,
                "metric": "violating_lanes", "value": violations(cfg, st),
                "comparable": True, "tol": 0.0})

    # ---- scrub recovery: inject -> detect -> repair -> replay on -------
    cfg = cfg_for(Policy.LRU)
    be = make("torch", cfg)
    hits_clean, _, _, _ = be.replay(be.init(), chunks, enabled)
    hr_clean = float(int(hits_clean.sum())) / n
    records.append({
        "id": "robust-scrub/clean/hit_ratio", "site": None, "n": n,
        "metric": "hit_ratio", "value": round(hr_clean, 6),
        "comparable": True, "tol": 1e-6})
    half = chunks.shape[0] // 2
    for site in ("keys", "fprint", "meta_a"):
        if progress:
            progress(f"scrub {site}")
        h1, _, st, _ = be.replay(be.init(), chunks[:half], enabled[:half])
        st, _ = faults.flip_bit(st, site, seed=seed, step=half)
        st, forced, _ = scrub(cfg, st, vals_mode="key")
        h2, _, st, _ = be.replay(st, chunks[half:], enabled[half:])
        hr = (float(int(h1.sum())) + float(int(h2.sum()))) / n
        records.append({
            "id": f"robust-scrub/{site}/hit_ratio", "site": site, "n": n,
            "seed": seed, "step": half, "metric": "hit_ratio",
            "value": round(hr, 6), "clean_value": round(hr_clean, 6),
            "comparable": True, "tol": 1e-6})
        records.append({
            "id": f"robust-scrub/{site}/forced_evictions", "site": site,
            "seed": seed, "step": half, "metric": "forced_evictions",
            "value": float(int(forced)), "comparable": True, "tol": 0.0})

    # ---- degradation ladder under a forced shared-memory breach --------
    if progress:
        progress("ladder smem-breach")
    c0 = events.cursor()
    with backend_mod.smem_budget(0):
        out = resilient_replay(cfg, chunks, enabled, device=dev)
    n_events = len(events.since(c0))
    records.append({
        "id": "robust-ladder/smem-breach/rung", "metric": "ladder_rung",
        "rung": out.rung, "value": float(RUNGS.index(out.rung)),
        "comparable": True, "tol": 0.0})
    records.append({
        "id": "robust-ladder/smem-breach/hit_ratio", "metric": "hit_ratio",
        "value": round(float(int(out.hits.sum())) / n, 6),
        "clean_value": round(hr_clean, 6),
        "comparable": True, "tol": 1e-6})
    records.append({
        "id": "robust-ladder/smem-breach/events", "metric": "event_count",
        "value": float(n_events), "comparable": False})

    # ---- expiry lane: TTL parity + expiry-scrub cost band --------------
    if ttl:
        from repro_torch.core.simulate import _pad_ttl_chunks

        ttl_rng = np.random.default_rng(seed + 1)
        tt = _pad_ttl_chunks(ttl_rng.integers(0, 200, n).astype(np.int32),
                             batch)
        ttl_hits = {}
        for backend in ("torch", "cuda"):
            if progress:
                progress(f"ttl clean {backend}")
            be_t = make(backend, cfg)
            h, _, st, _ = be_t.replay(be_t.init(ttl=True), chunks, enabled,
                                      ttls=tt)
            ttl_hits[backend] = float(int(h.sum()))
            records.append({
                "id": f"robust-ttl/clean/{backend}/violations",
                "backend": backend, "n": n, "metric": "violating_lanes",
                "value": violations(cfg, st), "comparable": True,
                "tol": 0.0})
        hr_ttl = ttl_hits["torch"] / n
        records.append({
            "id": "robust-ttl/parity/hit_ratio", "n": n,
            "metric": "hit_ratio", "value": round(hr_ttl, 6),
            "comparable": True, "tol": 1e-6})
        records.append({
            "id": "robust-ttl/parity/backend_max_diff", "n": n,
            "metric": "hit_diff",
            "value": abs(ttl_hits["torch"] - ttl_hits["cuda"]),
            "comparable": True, "tol": 0.0})
        for site_name, inject in (("clock_skew", faults.clock_skew),
                                  ("stale_entry", faults.stale_entry)):
            if progress:
                progress(f"ttl scrub {site_name}")
            h1, _, st, _ = be.replay(be.init(ttl=True), chunks[:half],
                                     enabled[:half], ttls=tt[:half])
            st, _ = inject(st, seed=seed, step=half)
            st, forced, _ = scrub(cfg, st, vals_mode="key")
            h2, _, st, _ = be.replay(st, chunks[half:], enabled[half:],
                                     ttls=tt[half:])
            hr = (float(int(h1.sum())) + float(int(h2.sum()))) / n
            records.append({
                "id": f"robust-ttl/scrub/{site_name}/hit_ratio",
                "site": site_name, "n": n, "seed": seed, "step": half,
                "metric": "hit_ratio", "value": round(hr, 6),
                "clean_value": round(hr_ttl, 6),
                "comparable": True, "tol": 1e-6})
            records.append({
                "id": f"robust-ttl/scrub/{site_name}/forced_evictions",
                "site": site_name, "seed": seed, "step": half,
                "metric": "forced_evictions", "value": float(int(forced)),
                "comparable": True, "tol": 0.0})

    # ---- validator overhead on the quick replay ------------------------
    interval = 1
    ov_sets, ov_ways, ov_batch = 512, 8, 256
    ov_n = 8_192 if quick else 65_536
    iters = 3 if quick else 5
    if progress:
        progress(f"overhead n={ov_n} interval={interval}")
    ov_cfg = KWayConfig(num_sets=ov_sets, ways=ov_ways, policy=Policy.LRU)
    ov_tr = traces.generate("zipf", ov_n, seed=7)
    ov_chunks, ov_enabled = pad_chunks(ov_tr, ov_batch)
    ov_be = make("torch", ov_cfg)

    def plain():
        h, _, _, _ = ov_be.replay(ov_be.init(), ov_chunks, ov_enabled)
        return int(h.sum())

    def validated():
        h, _, _, _, alarm = validated_replay(
            ov_cfg, ov_chunks, ov_enabled, backend="torch",
            interval=interval, vals_mode="key", device=dev)
        return int(h.sum()) + int(alarm) * 0

    t_plain = time_replay_percentiles(plain, iters=iters, warmup=1)
    t_val = time_replay_percentiles(validated, iters=iters, warmup=1)
    pct = (t_val["p50"] - t_plain["p50"]) / t_plain["p50"] * 100.0
    records.append({
        "id": "robust-overhead/validated-replay/pct",
        "metric": "overhead_pct", "value": round(pct, 2),
        "interval": interval, "n": ov_n, "batch": ov_batch,
        "capacity": ov_sets * ov_ways,
        "plain_p50_s": round(t_plain["p50"], 6),
        "validated_p50_s": round(t_val["p50"], 6),
        "comparable": False})

    spec = {"quick": quick, "ttl": ttl, "num_sets": num_sets, "ways": ways,
            "batch": batch, "n": n, "seed": seed,
            "trace_fingerprint": trace_io.trace_fingerprint(tr),
            "scrub_sites": ["keys", "fprint", "meta_a"],
            "overhead": {"num_sets": ov_sets, "ways": ov_ways,
                         "batch": ov_batch, "n": ov_n,
                         "interval": interval}}
    return spec, records, []


def hierarchy(quick: bool = False, progress=None, device=None):
    """Two-level replay hierarchy (kernel 4 on ``cuda``): throughput and hit
    ratio vs total capacity across the L1-size knob.

    Timing rows (``hier-tp/...``, not comparable): whole-trace replay req/s
    of the flat path and of the hierarchy at L2 512 x 8 and 4096 x 8.
    ``over_budget`` is ``not resident_fits`` (kernel 3's size rule on the
    device): on the reference's TPU the 4096-set L2 lay past its VMEM
    cliff; on an H100 both sizes fit kernel 3 at batch 256 (its shared
    memory per block grows with the batch and the sets an owner holds, not
    with the cache), so both flat rows run ``cuda-resident``.  The L2 sizes
    are the reference's; the H100 has no cliff there.  The reference's flat
    row calls the chunked replay under its ``pallas-resident`` label; the
    port's runs what its ``path`` says (kernel 3 where it fits).

    Hit-ratio rows (``hier-hr/{family}/l1-{K}``, comparable): a 64x8 L2
    with the L1 swept over {0, 16, 64} sets x 16 ways; ``l1-0`` carries
    ``scan_value`` (the flat replay, tol 0.0), the others ``flat_value`` (a
    flat cache of the same total capacity) and tol 0.02."""
    from repro_torch.core import trace_io, traces
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.simulate import SimConfig, replay_batched
    from repro_torch.kernels import replay as krp

    dev = resolve_device(device)
    policy = Policy.LRU
    batch = 256
    n = 16_384 if quick else 65_536
    hier = HierarchyConfig(l1_sets=64, l1_ways=16)
    l2_sets_sweep = (512, 4096)
    tr = traces.generate("zipf", n, seed=7, catalog=1 << 17)
    records = []

    for l2_sets in l2_sets_sweep:
        cfg = KWayConfig(num_sets=l2_sets, ways=8, policy=policy)
        flat_fits = krp.resident_fits(cfg, batch, False, dev)
        sim = SimConfig(cache=cfg, backend="cuda", device=dev)
        p50 = {}
        for mode, hcfg, path in (
                ("flat", None,
                 "cuda-resident" if flat_fits else "cuda-scan"),
                ("l1l2", hier, "cuda-resident-l1l2")):
            if progress:
                progress(f"hier timing {mode} s{l2_sets}")
            st = time_replay_percentiles(
                lambda _h=hcfg, _f=flat_fits: replay_batched(
                    sim, tr, batch=batch, hierarchy=_h,
                    resident=_h is None and _f),
                iters=3 if quick else 5)
            p50[mode] = st["p50"]
            records.append(_tp_record(
                f"hier-tp/{mode}/s{l2_sets}", batch, n / st["p50"] / 1e6,
                n=n, mode=mode, path=path, l2_sets=l2_sets,
                l2_capacity=cfg.capacity, over_budget=not flat_fits,
                p50_req_s=round(n / st["p50"], 1),
                p90_req_s=round(n / st["p90"], 1),
                reps_discarded=st["reps_discarded"]))
        records.append(_tp_record(
            f"hier-tp/speedup/s{l2_sets}", batch,
            p50["flat"] / p50["l1l2"],
            metric="speedup_x", l2_sets=l2_sets,
            over_budget=not flat_fits))

    # hit ratio vs total capacity across the L1-size knob
    trace_io.register_fixture_traces()
    n_hr = QUICK_N if quick else 16_384
    hr_batch = 64
    l2_hr = KWayConfig(num_sets=64, ways=8, policy=policy)
    for family in ("zipf", "lirs_two_pools"):
        kwargs = {"catalog": 4096} if family == "zipf" else {}
        trh = traces.generate(family, n_hr, seed=7, **kwargs)
        sim = SimConfig(cache=l2_hr, backend="cuda", device=dev)
        for l1_sets in (0, 16, 64):
            if progress:
                progress(f"hier-hr {family} l1-{l1_sets}")
            hcfg = HierarchyConfig(l1_sets=l1_sets, l1_ways=16)
            hr = replay_batched(sim, trh, batch=hr_batch, hierarchy=hcfg)
            total = l2_hr.capacity + hcfg.l1_capacity
            rec = {
                "id": f"hier-hr/{family}/l1-{l1_sets}",
                "family": family, "policy": policy.name,
                "l1_sets": l1_sets, "l1_ways": hcfg.l1_ways,
                "l2_capacity": l2_hr.capacity, "total_capacity": total,
                "batch": hr_batch, "n": n_hr,
                "metric": "hit_ratio", "value": hr, "comparable": True,
            }
            if l1_sets == 0:
                rec["scan_value"] = replay_batched(sim, trh, batch=hr_batch)
                rec["tol"] = 0.0
            else:
                flat = KWayConfig(num_sets=64, ways=total // 64,
                                  policy=policy)
                rec["flat_value"] = replay_batched(
                    SimConfig(cache=flat, backend="cuda", device=dev), trh,
                    batch=hr_batch)
                rec["tol"] = 0.02
            records.append(rec)

    ring, l1_bytes = krp.hier_smem_bytes(
        KWayConfig(num_sets=l2_sets_sweep[0], ways=8), hier, False)
    spec = {"quick": quick, "batch": batch, "n": n, "n_hr": n_hr,
            "hr_batch": hr_batch, "policy": policy.name,
            "l2_sets": list(l2_sets_sweep), "l2_ways": 8,
            "l1_sets": hier.l1_sets, "l1_ways": hier.l1_ways,
            "l1_footprint_bytes": l1_bytes, "l1_ring_bytes": ring,
            "smem_limit": krp.smem_limit(dev)}
    return spec, records, []


#: CLI name -> (function, canonical figure name)
FIGURES = {
    "hit_ratio": (hit_ratio_vs_associativity, "hit_ratio_vs_associativity"),
    "sampled_vs_limited": (sampled_vs_limited, "sampled_vs_limited"),
    "admission": (admission_ablation, "admission_ablation"),
    "throughput": (throughput_vs_batch, "throughput_vs_batch"),
    "throughput_resident": (throughput_resident, "throughput_resident"),
    "throughput_shards": (throughput_vs_shards, "throughput_vs_shards"),
    "showdown": (showdown, "showdown"),
    "synthetic_mix": (synthetic_mix, "synthetic_mix"),
    "serving": (serving, "serving"),
    "serving_engine": (serving_engine, "serving_engine"),
    "robustness": (robustness, "robustness"),
    "hierarchy": (hierarchy, "hierarchy"),
}
