"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then, at the full-size configuration of the slice (a 2^20-entry
8-way cache, 4 Mi zipf requests, batches of 1024):

  1. prints the card, its power limit and ptxas' register/shared-memory
     report of every kernel;
  2. holds kernels 1 and 2 (``kway_probe``, ``kway_fused_probe``) to their
     plain torch versions on a full-size state, all 5 policies, every
     variant — exactly;
  3. holds kernel 3 (``replay_resident``) to the chunked torch twin and to
     the ``cuda`` backend's chunked path (kernel 2 + torch apply): per-chunk
     hits and evictions and the final state, exactly; LRU and HYPERBOLIC at
     full size, and a TTL replay;
  4. reproduces the 36 committed k-way ``jnp`` hit ratios of
     ``benchmarks/baselines/quick.json`` through ``replay_batched(batch=1,
     resident=True)`` on the ``cuda`` backend, exactly;
  5. drives the main path through the user entry points
     (``simulate.replay_batched`` resident, chunked and two-phase, with and
     without TTLs, and ``peek_victims``) with every launch counter set to 0
     just before and read just after, and fails unless each kernel ran;
  6. times each kernel beside its bound and its plain version: CUDA events
     around back-to-back wrapper calls after a warm-up (what a caller pays,
     host overhead included) and the kernels' own device time from
     torch.profiler; and the requests/s of the resident and chunked
     replays.

Any mismatch or failure exits non-zero; no phase's failure is caught.  The
last two lines are the per-kernel JSON summary and the device JSON.  Needs
one CUDA card; without one it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
QUICK_JSON = os.path.join(HERE, "benchmarks", "baselines", "quick.json")

#: full-size configuration of the slice
NUM_SETS, WAYS, BATCH = 131072, 8, 1024
TRACE = dict(family="zipf", n=2**22, seed=0, catalog=2**24, alpha=0.9)
MAIN_POLICIES = ("LRU", "HYPERBOLIC")
#: requests replayed to fill a state before probing it
PREFIX = 2**20
#: TTL replay (smaller: the chunked twin scrubs the whole state per chunk)
TTL_SETS, TTL_N, TTL_BATCH = 8192, 2**18, 1024
#: H100 SXM memory rate (bytes/s), the bound of every kernel here
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(card, msg):
    print(f"[{card}] {msg}", flush=True)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over pairs of integer tensors (0: exact)."""
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def state_pairs(a, b):
    from repro_torch.core import kway
    pairs = [(getattr(a, f), getattr(b, f)) for f in kway.STATE_LANES]
    pairs.append((a.clock.reshape(1), b.clock.reshape(1)))
    if (a.expiry is None) != (b.expiry is None):
        raise AssertionError("expiry lane present on one side only")
    if a.expiry is not None:
        pairs.append((a.expiry, b.expiry))
    return pairs


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the card (after a warm-up
    call unless the caller has already run it)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_device_ms(fn, reps: int, names) -> float | None:
    """Device time per call of the kernels whose names contain one of
    ``names``, from torch.profiler (CUPTI); None when the profiler records
    no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            total_us += getattr(ev, "device_time_total", 0.0)
    return total_us / 1e3 / reps if total_us > 0 else None


def chunked_busy_share(card, be, state, chunks, enabled):
    """Where the chunked path's time goes: device busy share of a replay
    of a few chunks under torch.profiler, and its costliest device ops."""
    from torch.profiler import ProfilerActivity, profile
    be.replay_scan(state, chunks, enabled)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.replay_scan(state, chunks, enabled)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [(getattr(ev, "self_device_time_total", 0.0), ev.key)
           for ev in prof.key_averages()]
    busy_us = sum(t for t, _ in ops)
    top = ", ".join(f"{k[:40]} {t / 1e3:.3f} ms" for t, k in
                    sorted(ops, reverse=True)[:5] if t > 0)
    say(card, f"cuda chunked path, {len(chunks)} chunks under the profiler: "
              f"wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} "
              f"ms ({busy_us / wall_us:.1%}); top device ops: {top}")


def lanes_read(policy) -> int:
    """State lanes the function reads per row it probes: keys (the probe
    and the empty-way check), meta_a (every policy but RANDOM) and meta_b
    (HYPERBOLIC).  The fingerprint lane only pre-filters the key compare,
    so the function does not need it."""
    from repro_torch.core.policies import Policy
    return {Policy.RANDOM: 1, Policy.HYPERBOLIC: 3}.get(policy, 2)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(card):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    say(card, f"kernels built in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                say(card, f"  {name}.cu: {line.strip()}")


def fill_state(cfg, trace_chunks, dev):
    """A full-size state filled by a replay prefix (kernel 3)."""
    from repro_torch.core.backend import make_backend
    be = make_backend("cuda", cfg, dev)
    chunks, enabled = trace_chunks
    _, _, state, _ = be.replay(be.init(), chunks, enabled)
    return state


def phase_probe_kernels(card, trace, dev, results):
    """Kernels 1 and 2 against their plain versions, 5 policies."""
    from repro_torch.core import hashing, kway, router
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ref as kref

    prefix = router.pad_chunks(trace[:PREFIX], BATCH)
    q = hashing.key_tensor(trace[PREFIX:PREFIX + BATCH], dev)
    en = torch.from_numpy(np.random.default_rng(0).random(BATCH) < 0.9).to(dev)
    err1 = err2 = 0
    for policy in Policy:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=policy)
        st = fill_state(cfg, prefix, dev)
        qk, sets = kway.route(cfg, q)
        sets = sets.to(torch.int32)
        tg = st.clock + torch.arange(BATCH, dtype=torch.int32, device=dev)
        tp = tg + BATCH
        lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
        for variant in ("hits", "victim", "order"):
            kw = dict(policy=policy, full_order=variant == "order",
                      need_victims=variant != "hits")
            got = kp.kway_probe(*lanes, sets, qk, tg, **kw)
            want = kref.kway_probe_ref(*lanes, sets, qk, tg, **kw)
            e = max_abs_err(zip(got, want))
            if e:
                raise AssertionError(f"kway_probe {policy.name}/{variant}: "
                                     f"max abs err {e}")
            err1 = max(err1, e)
        got = kp.kway_fused_probe(*lanes, sets, qk, tg, tp, en, policy=policy)
        want = kref.kway_fused_probe_ref(*lanes, sets, qk, tg, tp, en,
                                         policy=policy)
        err2 = max_abs_err(zip(got, want))
        if err2:
            raise AssertionError(f"kway_fused_probe {policy.name}: max abs "
                                 f"err {err2}")
        hit_ratio = float(got[0].float().mean())
        say(card, f"kernels 1+2 == plain on the full-size {policy.name} "
                  f"state (occupancy {int(st.occupancy())}/{cfg.capacity}, "
                  f"{BATCH} queries, probe hit share {hit_ratio:.3f})")
    results["kway_probe"]["max_abs_err"] = err1
    results["kway_fused_probe"]["max_abs_err"] = err2


def phase_replay_kernel(card, trace, ttl_trace, dev, results):
    """Kernel 3 == chunked torch twin == cuda chunked path, exactly."""
    from repro_torch.core import router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    err = 0
    runs = [(Policy.parse(p), NUM_SETS, trace, None, BATCH)
            for p in MAIN_POLICIES]
    keys, ttls = ttl_trace
    runs.append((Policy.LRU, TTL_SETS, keys,
                 simulate._pad_ttl_chunks(ttls, TTL_BATCH), TTL_BATCH))
    for policy, sets, tr, tt, batch in runs:
        cfg = KWayConfig(num_sets=sets, ways=WAYS, policy=policy)
        chunks, en = router.pad_chunks(tr, batch)
        cb = make_backend("cuda", cfg, dev)
        tb = make_backend("torch", cfg, dev)
        ttl = tt is not None
        t0 = time.perf_counter()
        h1, e1, s1, _ = cb.replay(cb.init(ttl=ttl), chunks, en, ttls=tt)
        sync(dev)
        t1 = time.perf_counter()
        h2, e2, s2, _ = tb.replay(tb.init(ttl=ttl), chunks, en, ttls=tt)
        sync(dev)
        t2 = time.perf_counter()
        h3, e3, s3, _ = cb.replay_scan(cb.init(ttl=ttl), chunks, en, ttls=tt)
        sync(dev)
        t3 = time.perf_counter()
        for name, (h, e, s) in (("torch twin", (h2, e2, s2)),
                                ("cuda chunked", (h3, e3, s3))):
            d = max_abs_err([(h1, h), (e1, e)] + state_pairs(s1, s))
            if d:
                raise AssertionError(f"replay_resident {policy.name} "
                                     f"ttl={ttl}: != {name} (err {d})")
            err = max(err, d)
        n = len(tr)
        say(card, f"kernel 3 == torch twin == cuda chunked: {policy.name} "
                  f"S={sets} ways={WAYS} n={n} B={batch} ttl={ttl}: hits "
                  f"{int(h1.sum())} evictions {int(e1.sum())}, final clock "
                  f"{int(s1.clock)} (host wall: kernel {t1 - t0:.3f} s, "
                  f"twin {t2 - t1:.3f} s, chunked {t3 - t2:.3f} s)")
    results["replay_resident"]["max_abs_err"] = err


def phase_quick_records(card, dev):
    """The 36 committed k-way jnp hit ratios, exactly."""
    from repro_torch.core import simulate, traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    with open(QUICK_JSON) as f:
        recs = json.load(f)["records"]
    recs = [r for r in recs if r["backend"] == "jnp" and r["sample"] == 0
            and r["num_sets"] > 1 and r["admission"] == "none"]
    if len(recs) != 36:
        raise AssertionError(f"expected 36 k-way jnp records, got {len(recs)}")
    bad = []
    for r in recs:
        cfg = KWayConfig(num_sets=r["num_sets"], ways=r["ways"],
                         policy=Policy.parse(r["policy"]))
        tr = traces.generate(r["family"], r["n"], seed=r["seeds"][0])
        got = simulate.replay_batched(
            simulate.SimConfig(cfg, backend="cuda", device=dev), tr, batch=1,
            resident=True)
        if got != r["value"]:
            bad.append((r["id"], got, r["value"]))
    if bad:
        raise AssertionError(f"quick.json hit ratios differ: {bad}")
    say(card, "36/36 committed k-way hit ratios of quick.json reproduced "
              "exactly (cuda backend, replay_batched batch=1 resident=True)")


def launch_counts() -> dict:
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import replay as krp
    return {"kway_probe": kp.LAUNCHES["kway_probe"],
            "kway_fused_probe": kp.LAUNCHES["kway_fused_probe"],
            "replay_resident": krp.launches()}


def reset_launch_counts():
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import replay as krp
    for k in kp.LAUNCHES:
        kp.LAUNCHES[k] = 0
    krp.reset_trace_counts()


def phase_main_path(card, trace, ttl_trace, dev, results):
    """The slice's main path through the user entry points, counted."""
    from repro_torch.core import hashing, router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    keys, ttls = ttl_trace
    reset_launch_counts()
    for name in MAIN_POLICIES:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                         policy=Policy.parse(name))
        ratios = {}
        for form, kw in (("resident", dict(resident=True)),
                         ("chunked", {}), ("two_phase", {})):
            sim = simulate.SimConfig(cfg, backend="cuda", device=dev,
                                     two_phase=form == "two_phase")
            ratios[form] = simulate.replay_batched(sim, trace, batch=BATCH,
                                                   **kw)
        if len(set(ratios.values())) != 1:
            raise AssertionError(f"{name}: replay forms disagree: {ratios}")
        say(card, f"main path {name}: hit ratio {ratios['resident']!r} "
                  f"(resident == chunked == two-phase)")
        be = make_backend("cuda", cfg, dev)
        chunks, en = router.pad_chunks(trace[:PREFIX], BATCH)
        _, _, st, _ = be.replay(be.init(), chunks, en)
        vk, vv = be.peek_victims(st, trace[PREFIX:PREFIX + BATCH])
        if not bool(vv.any()) or hashing.EMPTY in vk[vv].tolist():
            raise AssertionError("peek_victims found no valid victim")
    cfg = KWayConfig(num_sets=TTL_SETS, ways=WAYS, policy=Policy.LRU)
    ttl_ratio = simulate.replay_batched(
        simulate.SimConfig(cfg, backend="cuda", device=dev), keys,
        batch=TTL_BATCH, resident=True, ttls=ttls)
    say(card, f"main path TTL (ttl_churn, S={TTL_SETS}): hit ratio "
              f"{ttl_ratio!r}")
    counts = launch_counts()
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path: {counts}")
        results[name]["launches"] = n
    say(card, f"main path launches: {counts}")


def phase_timing(card, trace, dev, results):
    """CUDA-event times of each kernel and its plain version at full size."""
    from repro_torch.core import hashing, kway, router
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import replay as krp

    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    st = fill_state(cfg, router.pad_chunks(trace[:PREFIX], BATCH), dev)
    q = hashing.key_tensor(trace[PREFIX:PREFIX + BATCH], dev)
    qk, sets = kway.route(cfg, q)
    sets = sets.to(torch.int32)
    tg = st.clock + torch.arange(BATCH, dtype=torch.int32, device=dev)
    tp = tg + BATCH
    en = torch.ones(BATCH, dtype=torch.bool, device=dev)
    lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
    row = WAYS * 4
    rows = int(torch.unique(sets).numel())

    # kernel 1, full-order variant (the put probe of the two-phase path):
    # reads lanes_read rows per distinct set + 12 B per query (set, key,
    # time), writes 16 + 4*ways B (hit, way, victim way and key, order)
    k1 = dict(policy=Policy.LRU, full_order=True)
    b1 = rows * lanes_read(Policy.LRU) * row + BATCH * (12 + 16 + row)
    ms = cuda_ms(lambda: kp.kway_probe(*lanes, sets, qk, tg, **k1), 200)
    plain = cuda_ms(lambda: kref.kway_probe_ref(*lanes, sets, qk, tg, **k1),
                    50)
    dev_ms = profiled_device_ms(
        lambda: kp.kway_probe(*lanes, sets, qk, tg, **k1), 50,
        ("probe_kernel",))
    results["kway_probe"].update(ms=ms, plain_ms=plain, device_ms=dev_ms,
                                 bound_ms=b1 / HBM_BYTES_PER_S * 1e3)
    kh = dict(policy=Policy.LRU, need_victims=False)
    ms_h = cuda_ms(lambda: kp.kway_probe(*lanes, sets, qk, tg, **kh), 200)
    say(card, f"kway_probe full_order B={BATCH}: {ms:.4f} ms per wrapper "
              f"call (CUDA events, back to back), kernel device time "
              f"{fmt_ms(dev_ms)} (torch.profiler), bound "
              f"{b1 / HBM_BYTES_PER_S * 1e3:.6f} ms ({b1} B), plain "
              f"{plain:.4f} ms; hits-only variant {ms_h:.4f} ms per call; "
              f"library_ms: none")

    # kernel 2 (its wrapper: meta_a copy + 2 launches); the function reads
    # lanes_read rows per distinct set + 17 B per query (set, key, two
    # times, enable flag) and writes 8 + 4*ways B (hit, way, order)
    b2 = rows * lanes_read(Policy.LRU) * row + BATCH * (17 + 8 + row)
    ms = cuda_ms(lambda: kp.kway_fused_probe(*lanes, sets, qk, tg, tp, en,
                                             policy=Policy.LRU), 200)
    plain = cuda_ms(lambda: kref.kway_fused_probe_ref(
        *lanes, sets, qk, tg, tp, en, policy=Policy.LRU), 50)
    dev_ms = profiled_device_ms(
        lambda: kp.kway_fused_probe(*lanes, sets, qk, tg, tp, en,
                                    policy=Policy.LRU), 50,
        ("fused_hit_kernel", "fused_order_kernel"))
    results["kway_fused_probe"].update(ms=ms, plain_ms=plain,
                                       device_ms=dev_ms,
                                       bound_ms=b2 / HBM_BYTES_PER_S * 1e3)
    say(card, f"kway_fused_probe B={BATCH}: {ms:.4f} ms per wrapper call "
              f"(CUDA events), device time of its 2 kernels "
              f"{fmt_ms(dev_ms)} (torch.profiler), bound "
              f"{b2 / HBM_BYTES_PER_S * 1e3:.6f} ms ({b2} B), plain "
              f"{plain:.4f} ms; library_ms: none")

    # kernel 3: the whole trace; reads the trace (4 B key + 1 B flag per
    # request) and, of each row the trace touches, the lanes its policy
    # reads; writes the 5 lanes of the state it returns and 8 B per chunk
    for name in MAIN_POLICIES:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                         policy=Policy.parse(name))
        chunks, en_c = router.pad_chunks(trace, BATCH)
        qkeys = hashing.key_tensor(chunks, dev)
        enabled = torch.from_numpy(en_c).to(dev)
        be = make_backend("cuda", cfg, dev)
        st0 = be.init()
        touched = int(torch.unique(
            kway.route(cfg, qkeys.reshape(-1)[enabled.reshape(-1)])[1]).numel())
        b3 = (qkeys.numel() * 5 + touched * lanes_read(cfg.policy) * row
              + len(kway.STATE_LANES) * NUM_SETS * row + 8 * chunks.shape[0])
        ms = cuda_ms(lambda: krp.replay_resident(cfg, st0, qkeys, enabled), 3)
        # both ran at this size in phase_replay_kernel: no warm-up call
        plain = cuda_ms(lambda: krp.replay_ref(cfg, st0, qkeys, enabled), 1,
                        warmup=False)
        chunked = cuda_ms(lambda: be.replay_scan(st0, chunks, en_c), 1,
                          warmup=False)
        n = len(trace)
        say(card, f"replay_resident {name} n={n} B={BATCH}: {ms:.3f} ms/launch"
                  f" ({n / ms * 1e3:.0f} requests/s), bound "
                  f"{b3 / HBM_BYTES_PER_S * 1e3:.4f} ms ({b3} B; {touched} "
                  f"of {NUM_SETS} sets touched), plain "
                  f"(torch twin) {plain:.3f} ms ({n / plain * 1e3:.0f} "
                  f"requests/s), cuda chunked path {chunked:.3f} ms "
                  f"({n / chunked * 1e3:.0f} requests/s); library_ms: none")
        if name == "LRU":
            chunked_busy_share(card, be, st0, chunks[:64], en_c[:64])
            dev_ms = profiled_device_ms(
                lambda: krp.replay_resident(cfg, st0, qkeys, enabled), 1,
                ("replay_kernel",))
            say(card, f"replay_resident {name}: kernel device time "
                      f"{fmt_ms(dev_ms)} (torch.profiler)")
            results["replay_resident"].update(
                ms=ms, plain_ms=plain, device_ms=dev_ms,
                bound_ms=b3 / HBM_BYTES_PER_S * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import traces

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    say(card, f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {kind} x{torch.cuda.device_count()}")
    phase_build(card)

    state_bytes = NUM_SETS * WAYS * 4
    say(card, f"full-size config: capacity {NUM_SETS * WAYS} entries = "
              f"{NUM_SETS} sets x {WAYS} ways")
    say(card, f"full-size config: state {5 * state_bytes} B in 5 int32 lanes "
              f"+ {state_bytes} B expiry lane")
    say(card, f"full-size config: trace traces.generate({TRACE['family']!r}, "
              f"{TRACE['n']}, seed={TRACE['seed']}, catalog={TRACE['catalog']},"
              f" alpha={TRACE['alpha']}), batch {BATCH} = "
              f"{TRACE['n'] // BATCH} chunks, policies {MAIN_POLICIES}")
    t0 = time.perf_counter()
    trace = traces.generate(TRACE["family"], TRACE["n"], seed=TRACE["seed"],
                            catalog=TRACE["catalog"], alpha=TRACE["alpha"])
    ttl_trace = traces.generate_ttl("ttl_churn", TTL_N, seed=0,
                                    catalog=1 << 15)
    say(card, f"trace length {len(trace)} generated in "
              f"{time.perf_counter() - t0:.1f} s")

    results = {
        "kway_probe": dict(
            source="src/repro_torch/kernels/csrc/kway_probe.cu",
            replaces="src/repro/kernels/kway_probe.py:183"),
        "kway_fused_probe": dict(
            source="src/repro_torch/kernels/csrc/kway_probe.cu",
            replaces="src/repro/kernels/kway_probe.py:337"),
        "replay_resident": dict(
            source="src/repro_torch/kernels/csrc/replay.cu",
            replaces="src/repro/kernels/replay.py:549"),
    }
    for phase, args in ((phase_probe_kernels, (trace, dev, results)),
                        (phase_replay_kernel, (trace, ttl_trace, dev,
                                               results)),
                        (phase_quick_records, (dev,)),
                        (phase_main_path, (trace, ttl_trace, dev, results)),
                        (phase_timing, (trace, dev, results))):
        t0 = time.perf_counter()
        phase(card, *args)
        say(card, f"{phase.__name__} done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "exact": r["max_abs_err"] == 0,
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    print("kernels " + ", ".join(
        f"{k['name']}: launches={k['launches']} exact={k['exact']} "
        f"ms={k['ms']:.4f}" for k in kernels) + f" [{card}]")
    say(card, f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
