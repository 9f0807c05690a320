"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then, at the full-size configuration of the replay slices (a
2^20-entry 8-way cache, 4 Mi zipf requests, batches of 1024; TinyLFU sized
by ``for_capacity(2^20)``; an L1 of 512 x 16 over that cache) and of the
serving slice:

  1. prints the card, its power limit and ptxas' register/shared-memory
     report of every kernel;
  2. holds kernels 1 and 2 (``kway_probe``, ``kway_fused_probe``: one
     launch each, the route inside) to their plain torch versions on a
     full-size state, all 5 policies, every variant, on the raw keys of a
     1024-query and a 16384-query batch — exactly, in the same dtypes, and
     kernel 2 leaving meta_a as it was; and counts the device kernels of
     one ``ops.fused_probe`` call (it must be 1): its kernel by the
     wrapper's launch counter, any other by torch.profiler;
  3. holds kernel 3 (``replay_resident``) to the chunked torch twin and to
     the ``cuda`` backend's chunked path (kernel 2 + torch apply): per-chunk
     hits and evictions and the final state, exactly; LRU on the first
     2^21 requests (the main path holds the whole trace's resident run to
     the chunked path), HYPERBOLIC on the first 2^20, and a TTL replay;
     then the skew
     check: 2^20 requests of which every other one is the same key, held
     exactly to the twin;
  4. holds kernel 3's TinyLFU branch to the chunked torch twin (record ->
     peek -> admit -> access) at full size, LRU over the first 2^20
     requests, LFU over the first 2^19 and a run whose sample (2^20) ages
     the sketch twice over the first 2^21: per-chunk counts, final state and final sketch,
     exactly;
     the ``cuda`` chunked path (kernel 1 peeks, kernel 2 probes) equals
     both on the LRU run;
  5. holds kernel 4 (``replay_hierarchical``) to its plain version
     (``hierarchy.replay_l1_over_l2``, run on CPU tensors) over the first
     2^14 requests against the full-size L2 filled by a 2^20-request flat
     prefix, LRU and HYPERBOLIC, a TTL run, and 2^14 requests through an
     aliasing-heavy hierarchy (L2 64 x 8 under L1 16 x 16, where most L2
     rows the kernel copies ahead are written before they are used):
     per-chunk counts and both tiers, exactly;
  6. reproduces the 36 committed k-way ``jnp`` hit ratios of
     ``benchmarks/baselines/quick.json`` (``replay_batched(batch=1,
     resident=True)``), the 4 ``resident-eq/*/tinylfu`` ratios and the 6
     ``hier-hr/*`` ratios, on the ``cuda`` backend, exactly;
  7. drives the main paths through the user entry points, each with every
     launch counter set to 0 just before and read just after: the flat path
     (``simulate.replay_batched`` resident, chunked and two-phase, with and
     without TTLs, and ``peek_victims``), the TinyLFU path (resident and
     chunked, on the first 2^20 requests) and the hierarchy (full depth,
     and a TTL run); fails unless each kernel of a path ran;
  8. times each kernel beside its bound and its plain version: CUDA events
     around wrapper calls (what a caller pays, host overhead included) and
     the kernels' own device time from torch.profiler; and the requests/s
     of the resident, chunked and hierarchical replays.  Kernels 1 and 2
     also at the ops level (``ops.probe_orders``, ``ops.fused_probe``: what
     the main path pays a call), with the host's time of one call split
     into its pieces (``probe_split``); and at 1024, 16384 and 2^24
     queries (the most a call takes; there held to the plain versions),
     with kernel 2's device time split into its phases by a measurement
     build (``-DKWAY_PHASE_CLOCKS``, built beside the library).  Kernel 3
     (flat and
     TinyLFU, whole trace) also reports its bucketing alone and its share,
     the grid its owners form ran on (from the profiler's trace: more than
     one block), and its TinyLFU forms at narrow chunks (grid against
     block; both equal bit for bit).  Kernel 4's entry is
     timed and bounded on the inputs of its check in 5, where its plain
     version ran too; its whole-trace run is reported under ``full_*``, and
     its global-L1 form under ``global_*``: the whole trace with the L1 in
     HBM (shared memory ruled out), equal to the shared-memory run bit for
     bit, and an L1 too large for shared memory (its first 2^14 requests
     equal to the plain version);
  9. serving, at deepseek-7b's full width (random bf16 weights from seed
     0; engine and traffic in ``SERVE_*``): a smoke-sized prefill and paged
     decode on the card agree with the CPU; 16 requests through
     ``Engine.submit`` / ``Engine.run`` on the ``cuda`` backend with the
     launch counters set to 0 just before (fails unless kernel 5 ran 30 x
     decode_steps times and kernel 1 ran), every layer's kernel-5 inputs of
     one decode step captured; the ``torch`` backend's run equal in stats,
     pages, prefix hits and tokens; one wave under torch.profiler; the
     serving CLI once; then the device-resident tick
     (``EngineConfig(jitted=True)``, CUDA graphs) on the same requests,
     and with decode_block=4 and TinyLFU, each held to the host loop
     (stats, hit ratio, per-request token counts and prefix hits equal,
     tokens equal or a bf16 tie), its replays run under
     ``set_sync_debug_mode("error")``, one capture per graph kind; two
     profiled waves count kernels 2, 1 and 5 as device rows of the
     replays (the wrappers' counters move only at capture); tokens/s of
     the tick and the host loop in turns (host / tick / tick / host, one
     round);
 10. kernel 5 (``paged_attention``) against its plain version on the
     captured inputs (bf16 at 3e-2, float32 at 2e-5 with TF32 off) and on
     a GQA + softcap case, then timed round-robin over the captured layers
     (as a decode step runs them) beside its bound, the wrapper's host
     time and ``scaled_dot_product_attention`` on the same K/V
     pre-gathered; and on layer 0 alone, as the previous design was
     timed.  Each kernel prints its previous design's figures on a line of
     its own, as constants (not in the JSON summary).

Between 9 and 10, set sharding and the robustness layer, each path counted
(every launch counter set to 0 just before it, read just after):

 11. sharded replay (``core/sharded.py``) on the main path's state and
     trace: LRU resident at D = 1, 2, 4, 8 (D kernel-3 launches each; hits
     and the global view's keys and vals equal to the unsharded kernel-3
     run) and ``replay_batched(shards=4)``; HYPERBOLIC and per-shard
     TinyLFU at D = 4 against the sharded torch twin on the card (every
     lane and sketch word, 2^17 requests); TTL at D = 2 equal to the
     unsharded TTL replay; overflow-defer at D = 8 (256 lanes a bucket)
     against the twin; the chunked sharded path at D = 4 (kernel 2 per
     shard per chunk, 2^19 requests) equal to the resident one; the
     sharded hierarchy (a private L1 of 512 x 16 per shard) at D = 2
     against kernel 4's plain version; then each D timed (ms per replay,
     requests/s, kernel 3's device ms per shard launch, the routing's ms);
 12. sharded serving: ``EngineConfig(shards=D)``, D = 2 and 4, the host
     loop at deepseek-7b's width, equal to ``shards=1`` in tokens, stats,
     hit ratio and evictions; tokens/s of D = 1, 2, 4, one run each;
 13. the robustness layer: ``check_cache`` clean on the main path's final
     state; ``flip_bit`` at each site, ``stale_entry``, ``clock_skew`` and
     ``double_resident`` detected at their set / way, ``scrub`` on the card
     equal to ``scrub`` on the CPU; ``check_cache`` and ``scrub`` timed
     beside their bytes bound; ``validated_replay`` (cuda, every 64
     chunks) equal to the main path's hits; ``resilient_replay`` on its top
     rung (``cuda-resident``, with the hierarchy ``cuda-resident-l1l2``)
     with no event;
 14. the robust tick: ``check_serve`` clean mid-run and drained at full
     width, ``inject_nan`` named ``nan_in_kv``, ``double_book_page``
     ``double_booked``; a crash mid-tick at full width and 4 layers
     (``CheckpointedEngine`` every 4 ticks, the next save never
     committed) restored into a fresh engine's captured graphs, its run
     equal to an uninterrupted one; the checkpoint's bytes and its save
     and restore seconds.

After 10, every model family (the deepseek-7b serving model freed):

 15. mixtral-8x22b at full width (d 6144, 48 x 128 heads, 8 KV heads, 8
     experts top-2 as 16 virtual experts of d_ff 8192, vocab 32768), its
     depth cut to 4 layers (56 are 282 GB), random from seed 0: a smoke
     MoE prefill and paged decode on the card held to the CPU; the 16
     requests through ``Engine.run`` on the ``cuda`` backend, counted
     (kernel 5 4 x decode_steps times, kernel 1 ran), the ``torch``
     backend's run equal; the tick (CUDA graphs, one capture per kind),
     greedy and with the reference's sampler (temperature 0.8, seed 3,
     decode_block 4), each held to the host loop under the same config
     (stats, hit ratio, token counts and prefix hits equal; tokens equal,
     or a bf16 tie at the first divergence in the host loop's own logits
     plus that step's Gumbel noise); tokens/s host / tick / tick / host;
     the decode tick's host ms and device ms (CUDA events over
     back-to-back replays of its graph) beside its bytes bound (every
     expert's weights: the dispatch is dense); then ``lm.forward``
     against 8 ``decode_step``s at full width for mamba2-130m,
     hymba-1.5b and seamless-m4t-large-v2 at full depth and mixtral at 4
     layers: in bf16 greedy tokens equal or tied, on a float32 copy of
     the weights every logit within 6e-2 (up to a MoE discontinuity: a
     dropped pair, or other experts after a gate tie).

Training (``data/``, ``optim/``, ``train/``, ``launch/train.py``) runs
first, while nvcc builds the kernels: no kernel of the port runs there,
and the launch counters, set to 0 before the timed cell and read after
it, show none.  It is:

 16. (a) three ``make_train_step`` steps of every family's smoke config on
     the card and on the host CPU from the same weights and batches
     (losses within 1e-3 relative, step-1 gradients within 3e-2 relative
     L2 per leaf); (b) gemma2-2b at full width and 2 layers, one [2, 32]
     batch's loss and gradients, card vs host CPU, and on the card with
     remat against without (the same loss, gradients within 3e-2; the
     largest difference printed); (c) gemma2-2b at full
     width and depth (2,614,222,080 parameters, seed 0) for 10 steps
     through ``launch.train.run`` with the launcher's defaults (batch 8 x
     seq 128, AdamW lr 3e-3 cosine, warmup 5), every block
     rematerialised (counted): losses finite and falling,
     every bf16 leaf moved; the step by CUDA events (forward + backward,
     optimizer; median of steps 4-10), tokens/s and peak memory beside the
     FLOP bound (6 x parameters x tokens at 989 TFLOP/s) and the
     optimizer's bytes bound; one more step under torch.profiler (device
     busy share, kernels, GEMMs); (d) mamba2-130m at full width and depth:
     6 steps with a checkpoint every 3, a resume to 10, against an
     uninterrupted run (data cursor equal, losses within 1e-3); (e)
     gemma2-2b at full size at train_4k's sequence length, batch 1 x seq
     4096: the dry run's peak on a one-device "cuda" mesh with remat and
     without, beside the card's memory, then 1 warm-up and 3 timed steps
     through ``launch.train.run`` (every block rematerialised, counted):
     finite losses, ``max_memory_allocated`` within 15 % of the remat
     prediction, ms a step, tokens/s, one step under torch.profiler.  Its
     numbers print as one ``{"train": ...}`` JSON line before the last
     three lines.

Then the mesh, the sharding rules and the dry run (``launch/mesh.py``,
``dist/sharding.py``, ``launch/dryrun.py``, ``roofline/``), on one
one-rank NCCL group:

 16b. (a) ``ShardedCache`` on a one-device ``sets`` mesh against
     ``mesh=None`` over the main trace's first 2^19 requests, LRU and
     TinyLFU: every chunk's outputs and the final lanes (and sketch)
     equal, kernel 2 (and kernel 1) counted into the JSON line; (b)
     ``launch.train.run`` through ``make_dev_mesh(1, 1)`` against no
     mesh, gemma2-2b full width 2 layers, 3 steps: equal losses; (c) the
     dry run's prediction of gemma2-2b's full-size step (seq 128 x batch
     8 in one pass, as phase_train's) on a one-device "cuda" mesh under
     ``FakeTensorMode``, then the same step for real: peak memory within
     15 %, FLOPs equal, ms a step beside the roofline's ``step_time``;
     (d) mixtral-8x22b ``decode_32k`` through ``python -m
     repro_torch.launch.dryrun`` on the fake 16x16 "cuda" mesh, in a
     subprocess beside (a)-(c).  Its numbers print as one ``{"mesh":
     ...}`` JSON line after the ``{"train": ...}`` one.

Last, the paper-figure sweep (``repro_torch/eval``), each figure run with
every launch counter and the sweep's capture counter set to 0 just before
it and read just after:

 17. every figure of ``eval.figures.FIGURES`` at ``quick=True`` on the card,
     with the arguments of its committed baseline (``throughput_shards``
     timed at shard count 1: its host-bound torch timing rows at 2, 4 and
     8 are cut for time; every comparable record stays), artifacts under
     ``chiprun_out/eval/``: one CUDA-graph capture per torch shape group
     and one kernel-3 launch per ``cuda`` sweep point (checked); each of
     the 8 committed baselines gated by the port's ``compare_to_baseline``
     (``quick.json``'s 96 records exactly, the seven ``BENCH_*_quick.json``
     within each record's tol, the 6 ``showdown-hr/*/cachetools`` records
     named as not reproducible without ``cachetools``); then the
     hit-ratio figure at full size (5 families, seeds 42-44, 60000
     requests), every ``cuda`` record equal to its ``torch`` record; a
     torch group's step eager against its CUDA graph; each figure's wall
     seconds, captures and launches, and the timing rows of the
     throughput and showdown figures beside the card.  The launches are
     added to the kernels' counts in the JSON line.

The figures of 13 and 14 (validation, scrub, checkpoint) are not kernel
work: they are printed on lines of their own and stay out of the JSON
summary, as does the checkpoint's size at full depth, which is computed
from the config and not measured.

Any mismatch or failure exits non-zero; no phase's failure is caught.  The
last two lines are the per-kernel JSON summary (6 entries) and the device
JSON of the one card the script drives.  Needs one CUDA card; without one
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINES = os.path.join(HERE, "benchmarks", "baselines")
QUICK_JSON = os.path.join(BASELINES, "quick.json")

#: full-size configuration of the slice
NUM_SETS, WAYS, BATCH = 131072, 8, 1024
TRACE = dict(family="zipf", n=2**22, seed=0, catalog=2**24, alpha=0.9)
MAIN_POLICIES = ("LRU", "HYPERBOLIC")
#: requests replayed to fill a state before probing it
PREFIX = 2**20
#: requests of kernel 3's LRU check against the torch twin (host-bound:
#: about 20 s for the whole 2^22 trace on an H100 host)
REPLAY_CHECK_N = 2**21
#: TTL replay (smaller: the chunked twin scrubs the whole state per chunk)
TTL_SETS, TTL_N, TTL_BATCH = 8192, 2**18, 1024
#: TinyLFU: the paper pairs it with LFU (and LRU); ``for_capacity`` of the
#: full-size cache never ages on this trace, so one more run ages twice
TL_POLICIES = ("LRU", "LFU")
TL_AGING = dict(width=2**20, door_bits=2**21, sample=2**20)
#: requests of the TinyLFU runs (LRU, LFU, aging) on which kernel 3 is
#: held to the twin: the chunked twin is host-bound (57-75 s a
#: 2^22-request run on an H100 host), so LRU runs a quarter of the trace,
#: LFU an eighth, and aging half (it ages twice there)
TL_N = (2**20, 2**19, 2**21)
#: hierarchy: the largest power-of-two L1 of 16 ways that fits one SM's
#: shared memory with its expiry lane, over the full-size L2
HIER_L1_SETS, HIER_L1_WAYS = 512, 16
HIER_POLICIES = ("LRU", "HYPERBOLIC")
#: requests the plain version of kernel 4 walks, one lane at a time
HIER_CHECK_N = 2**14
#: an L1 too large for one block's shared memory (320 KiB without the
#: expiry lane): kernel 4 keeps it in HBM (the global form)
HIER_GLOBAL_L1_SETS = 2 * HIER_L1_SETS
#: kernel 4 on an aliasing-heavy hierarchy (L2 64 x 8 under L1 16 x 16:
#: most rows it copies ahead are written by the lanes in between), held to
#: its plain version on the first HIER_ALIAS_N requests of the trace
HIER_ALIAS = dict(l2_sets=64, l1_sets=16, n=2**14)
#: hierarchy TTL run: L2 8192 x 8, L1 64 x 16, ttl_churn 2^15 requests
HIER_TTL_L1_SETS, HIER_TTL_N = 64, 2**15
#: kernel 3's skew check: SKEW_N requests of the trace, every other one
#: replaced by the trace's first key (one set takes half of all lanes)
SKEW_N = 2**20
#: kernel 3's device kernels (this design's and the one-block design's, so
#: that chip_ab.py times either tree)
KERNEL3_NAMES = ("bucket_", "owners_kernel", "grid_kernel", "block_kernel",
                 "replay_kernel")
#: TinyLFU chunk widths at which kernel 3's grid and block forms are timed
#: against each other, on the first TL_NARROW_N requests
TL_NARROW_BATCHES, TL_NARROW_N = (1, 8, 16, 32, 128, 1024), 2**14
#: H100 SXM memory rate (bytes/s), the bound of every kernel here
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate (FLOP/s), kernel 5's operations bound
BF16_FLOP_PER_S = 989e12
#: serving slice: deepseek-7b at full width (random bf16 weights made on the
#: card from seed 0), the engine of the chip configuration and its traffic
#: (a shared 384-token prefix plus a 16-128-token tail per request)
SERVE_ARCH = "deepseek-7b"
SERVE_ENGINE = dict(page=16, num_sets=8, ways=8, max_batch=8, max_seq=1024,
                    max_prompt=512, private_pages=960)
SERVE_REQUESTS, SERVE_SHARED, SERVE_TAIL, SERVE_MAX_NEW = 16, 384, (16, 128), 32
#: decode step whose every layer's kernel-5 inputs are captured: the last
#: step of the first wave (8 sequences, each its prompt + 32 tokens long)
SERVE_CAPTURE_STEP = 31
#: the profiled serving run: one wave of max_batch requests, fewer new
#: tokens (the profiler's event processing grows with the op count)
SERVE_PROFILE_MAX_NEW = 4
#: kernel 5's GQA + softcap case on random pools: gemma2-2b's heads
GQA_CASE = dict(b=8, kvh=4, g=2, d=256, softcap=50.0, pages=1024, page=16,
                pps=64)
#: kernel 5's tolerances against its plain version (the reference's own)
PA_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
#: the figures of kernels 1-5 in their previous designs (kernels 1 and 2
#: the keys routed in torch before the wrapper, kernel 2 two launches on a
#: copy of meta_a; kernel 3 one thread block, kernel 4 with both tiers in
#: HBM, kernel 5 one CTA per sequence and KV head): constants, measured by
#: this script (kernels 1 and 2's ops_* by chip_ab.py on the previous
#: design's tree) on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section
#: 6); kernels 1 and 2 at 1024 queries on the full-size state, kernel 3 on
#: the whole trace (LRU; TinyLFU for_capacity(2^20)), kernel 4 on its
#: 2^14-request check inputs and (full_) the whole trace, kernel 5 on layer
#: 0 of the captured decode step
PREV_DESIGN = {
    "kway_probe": dict(ms=0.0427, device_ms=0.0038, ops_ms=0.4855,
                       ops_host_us=474.6),
    "kway_fused_probe": dict(ms=0.0645, device_ms=0.0055, ops_ms=0.5126,
                             ops_host_us=495.5),
    "replay_resident": dict(ms=653.18, device_ms=651.70),
    "replay_resident_tinylfu": dict(ms=601.47, device_ms=600.25),
    "replay_hierarchical": dict(ms=29.444, device_ms=29.229,
                                full_ms=8037.56, full_device_ms=8036.35),
    "paged_attention": dict(ms=0.2004, device_ms=0.1432),
}
#: and, in bf16, the kernel and the plain version both compute in float32
#: and round once, so they may differ by about two bf16 ulps at most
PA_BF16_ROUNDING = dict(atol=1e-3, rtol=8e-3)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(card, msg):
    # one write a line: the kernel build's thread prints beside training
    sys.stdout.write(f"[{card}] {msg}\n")
    sys.stdout.flush()


def say_previous(card, name):
    """Print a kernel's previous-design figures, constants from PERF.md."""
    figs = ", ".join(f"{k}={v}" for k, v in PREV_DESIGN[name].items())
    say(card, f"{name} previous design (constants from PERF.md section 6, "
              f"not measured in this run): {figs}")


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over pairs of integer tensors (0: exact)."""
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(got.device, torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def state_pairs(a, b):
    from repro_torch.core import kway
    pairs = [(getattr(a, f), getattr(b, f).to(getattr(a, f).device))
             for f in kway.STATE_LANES]
    pairs.append((a.clock.reshape(1), b.clock.reshape(1).to(a.clock.device)))
    if (a.expiry is None) != (b.expiry is None):
        raise AssertionError("expiry lane present on one side only")
    if a.expiry is not None:
        pairs.append((a.expiry, b.expiry.to(a.expiry.device)))
    return pairs


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn):
    """(result, milliseconds) of one call of ``fn``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def sketch_pairs(a, b):
    return [(a.packed, b.packed), (a.door, b.door),
            (a.additions.reshape(1), b.additions.reshape(1))]


def hier_pairs(a, b):
    return state_pairs(a.l1, b.l1) + state_pairs(a.l2, b.l2)


def to_cpu(st):
    """A KWayState or HierState copied to CPU tensors."""
    import dataclasses
    if hasattr(st, "l1"):
        return type(st)(l1=to_cpu(st.l1), l2=to_cpu(st.l2))
    return dataclasses.replace(st, **{
        f.name: None if getattr(st, f.name) is None
        else getattr(st, f.name).cpu() for f in dataclasses.fields(st)})


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


def profiled_device_ms(fn, reps: int, names,
                       warmup: bool = True) -> float | None:
    """Device time per call of the kernels whose names contain one of
    ``names``, from torch.profiler (CUPTI); None when the profiler records
    no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(t for t, key in device_rows(prof)
                   if any(n in key for n in names))
    return total_us / 1e3 / reps if total_us > 0 else None


def device_rows(prof) -> list:
    """(self device us, name) of the device activity in ``prof``: the rows
    of ``key_averages()`` whose device type is CUDA (kernels, copies,
    sets), as the profiler's own table footer sums them.  Under kineto a
    CPU op's row also carries the device time of the kernels it launched,
    which have rows of their own, so adding every row would count those
    kernels twice."""
    from torch.autograd import DeviceType
    return [(ev.self_device_time_total, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


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
    ops = device_rows(prof)
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


def hier_bound_bytes(cfg, hc, before, after, qkeys, enabled) -> int:
    """Bytes kernel 4's function must move in one run: the key and enable
    streams (5 B per request); of each L1 and L2 row the live keys route to,
    the lanes its policy reads (a demoted key goes to its own L2 set, so the
    L2 rows are those of the live keys and of the keys in L1 at the start);
    all lanes of each row the run changed, written once; 8 B per chunk."""
    from repro_torch.core import hashing, hierarchy, kway

    def changed_rows(a, b):
        d = torch.zeros(a.keys.shape[0], dtype=torch.bool,
                        device=a.keys.device)
        for f in kway.STATE_LANES:
            d |= (getattr(a, f) != getattr(b, f)).any(1)
        if a.expiry is not None:
            d |= (a.expiry != b.expiry).any(1)
        return int(d.sum())

    live = hashing.sanitize_keys(qkeys.reshape(-1)[enabled.reshape(-1)])
    held = before.l1.keys.reshape(-1)
    held = held[held != hashing.EMPTY]
    l1_rows = int(torch.unique(hashing.set_index(
        live, hc.l1_sets, cfg.seed ^ hierarchy.L1_SEED_SALT)).numel())
    l2_rows = int(torch.unique(hashing.set_index(
        torch.cat([live, held]), cfg.num_sets, cfg.seed)).numel())
    ttl = before.l2.expiry is not None
    read = lanes_read(cfg.policy) + ttl
    lanes = len(kway.STATE_LANES) + ttl
    return (qkeys.numel() * 5
            + read * 4 * (l1_rows * hc.l1_ways + l2_rows * cfg.ways)
            + lanes * 4 * (changed_rows(before.l1, after.l1) * hc.l1_ways
                           + changed_rows(before.l2, after.l2) * cfg.ways)
            + 8 * qkeys.shape[0])


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def fmt_share(x) -> str:
    return "not measured" if x is None else f"{x:.1%}"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

#: the measurement build of kernels 1 and 2 (``-DKWAY_PHASE_CLOCKS``: kernel
#: 2's CTAs stamp clock64() at each phase), made beside the library
PHASE_CLOCKS_SO = {}


def phase_build(card):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"kway_probe-clocks-{_build._digest()}.so"
    clocks = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-DKWAY_PHASE_CLOCKS", "-o",
         str(so), str(_build.CSRC / "kway_probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _build.build_all()
    finally:
        out, _ = clocks.communicate()
    if clocks.returncode:
        raise RuntimeError(f"kway_probe.cu -DKWAY_PHASE_CLOCKS: nvcc exit "
                           f"{clocks.returncode}\n{out}")
    PHASE_CLOCKS_SO["path"] = so
    say(card, f"kernels built in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {' '.join(_build.NVCC_FLAGS)}; and kway_probe.cu "
              f"with -DKWAY_PHASE_CLOCKS for kernel 2's phase split)")
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
    """Kernels 1 and 2 (one launch each, the route inside) against their
    plain versions, 5 policies, on the raw keys of a 1024-query and a
    MAX_BATCH-query batch; and the device kernels of one ops call."""
    from repro_torch.core import hashing, router
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import replay as krp

    prefix = router.pad_chunks(trace[:PREFIX], BATCH)
    rng = np.random.default_rng(0)
    batches = []
    for b in (BATCH, krp.MAX_BATCH):
        q = hashing.key_tensor(trace[PREFIX:PREFIX + b], dev)
        batches.append((q, torch.from_numpy(rng.random(b) < 0.9).to(dev)))
    err1 = err2 = 0
    for policy in Policy:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=policy)
        st = fill_state(cfg, prefix, dev)
        route = dict(num_sets=cfg.num_sets, seed=cfg.seed, policy=policy)
        lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
        for q, en in batches:
            args = (*lanes, q, st.clock)
            for variant in ("hits", "victim", "order"):
                kw = dict(route, full_order=variant == "order",
                          need_victims=variant != "hits")
                got = kp.kway_probe(*args, **kw)
                want = kref.kway_probe_ref(*args, **kw)
                e = max_abs_err(zip(got, want))
                if e or [g.dtype for g in got] != [w.dtype for w in want]:
                    raise AssertionError(f"kway_probe {policy.name}/{variant}"
                                         f" B={len(q)}: max abs err {e}")
                err1 = max(err1, e)
            ma = st.meta_a.clone()
            got = kp.kway_fused_probe(*args, en, **route)
            want = kref.kway_fused_probe_ref(*args, en, **route)
            e = max_abs_err(list(zip(got, want)) + [(st.meta_a, ma)])
            if e or [g.dtype for g in got] != [w.dtype for w in want]:
                raise AssertionError(f"kway_fused_probe {policy.name} "
                                     f"B={len(q)}: max abs err {e}")
            err2 = max(err2, e)
        hit_ratio = float(got[2].float().mean())
        say(card, f"kernels 1+2 == plain on the full-size {policy.name} "
                  f"state (occupancy {int(st.occupancy())}/{cfg.capacity}, "
                  f"raw keys of {BATCH} and {krp.MAX_BATCH} queries, "
                  f"probe hit share {hit_ratio:.3f}; kernel 2 left meta_a "
                  f"as it was)")
    # one ops call is one device kernel (the route, the hits' updates and
    # the outputs' dtypes are all inside it)
    q, en = batches[0]
    counts = {name: device_kernel_count(fn) for name, fn in (
        ("probe_orders", lambda: ops.probe_orders(cfg, st, q)),
        ("fused_probe", lambda: ops.fused_probe(cfg, st, q, en)))}
    if counts["fused_probe"] != 1:
        raise AssertionError(f"ops.fused_probe ran {counts['fused_probe']} "
                             f"device kernels, not 1 (counts {counts})")
    say(card, f"device kernels of one ops call (the probe kernel by its "
              f"launch counter, any other by torch.profiler): {counts}")
    results["kway_probe"].update(max_abs_err=err1,
                                 ops_device_kernels=counts["probe_orders"])
    results["kway_fused_probe"].update(
        max_abs_err=err2, ops_device_kernels=counts["fused_probe"])


#: the names torch.profiler gives the port's kernels that ``ops.probe_orders``
#: and ``ops.fused_probe`` launch
PROBE_KERNEL_NAMES = ("(anonymous namespace)::probe_kernel<",
                      "(anonymous namespace)::fused_kernel<")


def device_kernel_count(fn) -> int:
    """Device activities (kernels, copies, sets) of one call of ``fn``,
    after a warm-up call: the port's kernels by their wrappers' launch
    counters, every other activity by torch.profiler.  CUPTI drops the
    records of the port's kernels (launched from their own libraries) in
    some sessions and torch's own in none of this script's runs, so the
    profiler's rows of the port's probe kernels are not counted."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    before = sum(launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    port = sum(launch_counts().values()) - before
    return port + sum(ev.count for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False)
                      and not any(n in ev.key for n in PROBE_KERNEL_NAMES))


def host_us(fn, calls: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the host's microseconds per call of ``fn``,
    over ``calls`` calls issued back to back (a sync before each rep)."""
    per = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return sorted(per)[reps // 2]


def probe_split(cfg, st, q, en) -> dict:
    """The host's microseconds per call of each piece of one
    ``ops.probe_orders`` and one ``ops.fused_probe`` call (the one-launch
    design: checks, one allocation, the current stream, the C call, the
    outputs' views), each piece timed alone by ``host_us`` on the same
    inputs."""
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ops

    b, ways, dev = q.shape[0], cfg.ways, q.device
    lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
    lib = kp._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed, pol = kp._i32(cfg.seed), int(cfg.policy)
    ptrs = [t.data_ptr() for t in (*lanes, q)]
    out = {}
    for name, mode, call, launch in (
            ("probe_orders", kp._ORDER, lambda: ops.probe_orders(cfg, st, q),
             lambda buf: lib.kway_probe_launch(
                 *ptrs, st.clock.data_ptr(), cfg.num_sets, seed, b, ways,
                 pol, kp._ORDER, buf, stream)),
            ("fused_probe", kp._FUSED,
             lambda: ops.fused_probe(cfg, st, q, en),
             lambda buf: lib.kway_fused_probe_launch(
                 *ptrs, en.data_ptr(), st.clock.data_ptr(), cfg.num_sets,
                 seed, b, ways, pol, buf, stream))):
        words = kp._words(b, ways, mode)
        buf = torch.empty(words, dtype=torch.int32, device=dev)
        ptr = buf.data_ptr()
        out[name] = dict(
            checks=host_us(lambda: kp._check(
                lanes, q, st.clock, en if mode == kp._FUSED else None)),
            allocations=host_us(lambda: torch.empty(
                words, dtype=torch.int32, device=dev)),
            stream=host_us(lambda: torch.cuda.current_stream(dev)
                           .cuda_stream),
            ctypes_launch=host_us(lambda: launch(ptr)),
            views=host_us(lambda: kp._views(buf, b, ways, mode)),
            ops_call=host_us(call))
    return out


def kernel2_phases(cfg, st, q, en, reps: int = 20) -> dict:
    """Kernel 2's device time split into its phases, from the measurement
    build: each CTA's clock64() cycles in (1) the batch scan, (2) the
    grouping by set, (3) the rows' lane groups, each phase ending at a
    barrier; the median over CTAs and ``reps`` launches, and each phase's
    share of the CTA's span.  Its outputs must equal the library's."""
    import ctypes
    from repro_torch.kernels import kway_probe as kp

    lib = kp.declare(ctypes.CDLL(str(PHASE_CLOCKS_SO["path"])))
    b, ways = q.shape[0], cfg.ways
    buf = torch.empty(kp._words(b, ways, kp._FUSED), dtype=torch.int32,
                      device=q.device)
    host = (ctypes.c_longlong * (256 * 4))()
    spans = []
    for _ in range(reps):
        _build_check(lib.kway_phase_clocks(None, 1))
        _build_check(lib.kway_fused_probe_launch(
            st.keys.data_ptr(), st.fprint.data_ptr(), st.meta_a.data_ptr(),
            st.meta_b.data_ptr(), q.data_ptr(), en.data_ptr(),
            st.clock.data_ptr(), cfg.num_sets, kp._i32(cfg.seed), b, ways,
            int(cfg.policy), buf.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream))
        torch.cuda.synchronize()
        _build_check(lib.kway_phase_clocks(host, 0))
        t = np.frombuffer(host, dtype=np.int64).reshape(256, 4)
        spans.append(np.diff(t[t[:, 3] > 0], axis=1))
    got = kp._views(buf, b, ways, kp._FUSED)
    want = kp.kway_fused_probe(st.keys, st.fprint, st.meta_a, st.meta_b, q,
                               st.clock, en, num_sets=cfg.num_sets,
                               seed=cfg.seed, policy=cfg.policy)
    if max_abs_err(zip(got, want)):
        raise AssertionError("kernel 2's measurement build != the library")
    cyc = np.concatenate(spans)
    med = np.median(cyc, axis=0)
    whole = float(np.median(cyc.sum(axis=1)))
    return dict(ctas=len(spans[0]), cta_cycles=whole,
                **{f"{k}_cycles": float(m) for k, m in
                   zip(("scan", "group", "rows"), med)},
                **{f"{k}_share": float(m) / whole for k, m in
                   zip(("scan", "group", "rows"), med)})


def _build_check(rc):
    from repro_torch.kernels import _build
    _build.check(rc, "kway_probe (-DKWAY_PHASE_CLOCKS)")


def say_split(card, split, design):
    for name, pieces in split.items():
        figs = ", ".join(f"{k} {v:.1f}" for k, v in pieces.items())
        say(card, f"{name} host split ({design}; us per call, median of 7 x "
                  f"200 calls of each piece alone): {figs}")


def probe_at_scale(card, cfg, st, trace, dev, results):
    """Kernels 1 and 2 on the full-size state at 1024 and MAX_BATCH queries
    and at the most a call takes (MAX_QUERIES, the trace's keys repeated),
    where kernel 2's CTAs each hold far more queries than shared memory
    lists: device time by torch.profiler, and kernel 2's phases from its
    measurement build; at MAX_QUERIES also equal to the plain versions."""
    from repro_torch.core import hashing
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import replay as krp

    route = dict(num_sets=cfg.num_sets, seed=cfg.seed, policy=cfg.policy)
    lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
    scale = {}
    for b in (BATCH, krp.MAX_BATCH, kp.MAX_QUERIES):
        q = hashing.key_tensor(np.resize(trace[PREFIX:], b), dev)
        en = torch.ones(b, dtype=torch.bool, device=dev)
        run1 = lambda: kp.kway_probe(*lanes, q, st.clock,  # noqa: E731
                                     full_order=True, **route)
        run2 = lambda: kp.kway_fused_probe(*lanes, q, st.clock,  # noqa: E731
                                           en, **route)
        reps = 3 if b == kp.MAX_QUERIES else 50
        if b == kp.MAX_QUERIES:
            e1 = max_abs_err(zip(run1(), kref.kway_probe_ref(
                *lanes, q, st.clock, full_order=True, **route)))
            e2 = max_abs_err(zip(run2(), kref.kway_fused_probe_ref(
                *lanes, q, st.clock, en, **route)))
            if e1 or e2:
                raise AssertionError(f"kernels 1/2 at {b} queries: max abs "
                                     f"err {e1} / {e2}")
            torch.cuda.empty_cache()
        ms1, ms2 = cuda_ms(run1, reps), cuda_ms(run2, reps)
        d1 = profiled_device_ms(run1, reps, ("probe_kernel",))
        d2 = profiled_device_ms(run2, reps, ("fused_kernel",))
        ph = kernel2_phases(cfg, st, q, en, reps=min(reps, 20))
        scale[b] = dict(k1_ms=ms1, k2_ms=ms2, k1_device_ms=d1,
                        k2_device_ms=d2, k2_phases=ph)
        checked = "; both == plain" if b == kp.MAX_QUERIES else ""
        say(card, f"B={b}: kernel 1 (full order) {ms1:.4f} ms per wrapper "
                  f"call (CUDA events), device {fmt_ms(d1)}; kernel 2 "
                  f"{ms2:.4f} ms, device {fmt_ms(d2)} (torch.profiler)"
                  f"{checked}; kernel 2's phases ({ph['ctas']} CTAs, median clock64 cycles of a "
                  f"CTA, measurement build): scan {ph['scan_cycles']:.0f} "
                  f"({ph['scan_share']:.1%}), group {ph['group_cycles']:.0f}"
                  f" ({ph['group_share']:.1%}), rows {ph['rows_cycles']:.0f} "
                  f"({ph['rows_share']:.1%}) of {ph['cta_cycles']:.0f}")
        del q, en
        torch.cuda.empty_cache()
    for key, k in (("kway_probe", "k1"), ("kway_fused_probe", "k2")):
        results[key]["scale_ms"] = {str(b): v[f"{k}_ms"]
                                    for b, v in scale.items()}
        results[key]["scale_device_ms"] = {str(b): v[f"{k}_device_ms"]
                                           for b, v in scale.items()}
    results["kway_fused_probe"]["scale_phases"] = {
        str(b): v["k2_phases"] for b, v in scale.items()}


def phase_replay_kernel(card, trace, ttl_trace, dev, results):
    """Kernel 3 == chunked torch twin == cuda chunked path, exactly: LRU on
    the first REPLAY_CHECK_N requests, HYPERBOLIC on the first PREFIX (the
    chunked runs are host-bound), and a TTL replay."""
    from repro_torch.core import router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    err = 0
    runs = [(Policy.LRU, NUM_SETS, trace[:REPLAY_CHECK_N], None, BATCH),
            (Policy.HYPERBOLIC, NUM_SETS, trace[:PREFIX], None, BATCH)]
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


def tl_runs():
    """(policy, TinyLFUConfig, label) of the full-size TinyLFU replays."""
    from repro_torch.core import admission
    from repro_torch.core.policies import Policy
    full = admission.for_capacity(NUM_SETS * WAYS)
    return [(Policy.parse(p), full, "for_capacity(2^20)")
            for p in TL_POLICIES] + [
        (Policy.LRU, admission.TinyLFUConfig(**TL_AGING), "aging")]


def phase_tinylfu_kernel(card, trace, dev, results):
    """Kernel 3's TinyLFU branch == the chunked torch twin, exactly, at full
    size on the first TL_N requests of each run; the cuda chunked path
    (kernel 1 peeks, kernel 2 probes) equals both on the first run."""
    from repro_torch.core import router
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig

    err = 0
    for k, (policy, tl, label) in enumerate(tl_runs()):
        n = TL_N[k]
        chunks, en = router.pad_chunks(trace[:n], BATCH)
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=policy)
        cb = make_backend("cuda", cfg, dev)
        tb = make_backend("torch", cfg, dev)
        got, ms = timed(lambda: cb.replay(cb.init(), chunks, en, tinylfu=tl))
        want, plain = timed(lambda: tb.replay(tb.init(), chunks, en,
                                              tinylfu=tl))
        sides = [("torch twin", want)]
        chunked = None
        if k == 0:
            scan, chunked = timed(lambda: cb.replay_scan(cb.init(), chunks,
                                                         en, tinylfu=tl))
            sides.append(("cuda chunked", scan))
        h1, e1, s1, k1 = got
        for name, (h, e, st, sk) in sides:
            d = max_abs_err([(h1, h), (e1, e)] + state_pairs(s1, st)
                            + sketch_pairs(k1, sk))
            if d:
                raise AssertionError(f"replay_resident TinyLFU {policy.name} "
                                     f"{label}: != {name} (err {d})")
            err = max(err, d)
        say(card, f"kernel 3 TinyLFU == torch twin"
                  f"{' == cuda chunked' if chunked else ''}: {policy.name} "
                  f"{label} (width {tl.width}, door_bits {tl.door_bits}, "
                  f"sample {tl.sample}, {n // tl.sample} agings; sketch "
                  f"{tl.nbytes()} B), n={n} B={BATCH}: hits {int(h1.sum())} "
                  f"evictions {int(e1.sum())}, final additions "
                  f"{int(k1.additions)} (CUDA events: kernel {ms:.3f} ms, "
                  f"twin {plain:.3f} ms"
                  + (f", cuda chunked {chunked:.3f} ms" if chunked else "")
                  + ")")
        if k == 0:
            results["replay_resident_tinylfu"].update(
                plain_ms=plain, chunked_ms=chunked,
                hit_ratio=int(h1.sum()) / n)
    results["replay_resident_tinylfu"]["max_abs_err"] = err


def phase_hier_kernel(card, trace, ttl_trace, dev, results):
    """Kernel 4 == its plain version (run on CPU tensors), exactly: the
    first HIER_CHECK_N requests against the full-size L2 filled by a
    PREFIX-request flat replay (kernel 3) under an empty L1, LRU and
    HYPERBOLIC; a TTL run from empty tiers; and the first HIER_ALIAS["n"]
    requests through the aliasing-heavy HIER_ALIAS hierarchy.  The LRU run's inputs are
    the ones kernel 4's JSON entry is timed and bounded on."""
    from repro_torch.core import hashing, hierarchy, router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import replay as krp

    hc = hierarchy.HierarchyConfig(l1_sets=HIER_L1_SETS,
                                   l1_ways=HIER_L1_WAYS)
    prefix = router.pad_chunks(trace[:PREFIX], BATCH)
    chunks, en = router.pad_chunks(trace[:HIER_CHECK_N], BATCH)
    runs = []
    for name in HIER_POLICIES:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                         policy=Policy.parse(name))
        st = hierarchy.as_hier_state(cfg, hc, fill_state(cfg, prefix, dev))
        runs.append((cfg, hc, st, chunks, en, None,
                     f"L2 filled by {PREFIX} requests"))
    keys, ttls = ttl_trace
    cfg = KWayConfig(num_sets=TTL_SETS, ways=WAYS, policy=Policy.LRU)
    hct = hierarchy.HierarchyConfig(l1_sets=HIER_TTL_L1_SETS,
                                    l1_ways=HIER_L1_WAYS)
    tch, ten = router.pad_chunks(keys[:HIER_TTL_N], TTL_BATCH)
    runs.append((cfg, hct,
                 hierarchy.make_hier(cfg, hct, device=dev, ttl=True), tch,
                 ten, simulate._pad_ttl_chunks(ttls[:HIER_TTL_N], TTL_BATCH),
                 "empty tiers, ttl_churn"))
    a = HIER_ALIAS
    cfg = KWayConfig(num_sets=a["l2_sets"], ways=WAYS, policy=Policy.LRU)
    hca = hierarchy.HierarchyConfig(l1_sets=a["l1_sets"],
                                    l1_ways=HIER_L1_WAYS)
    ach, aen = router.pad_chunks(trace[:a["n"]], BATCH)
    runs.append((cfg, hca, hierarchy.make_hier(cfg, hca, device=dev), ach,
                 aen, None, "empty tiers, aliasing-heavy"))
    err = 0
    for k, (cfg, h, st, ch, e, tt, label) in enumerate(runs):
        be = make_backend("cuda", cfg, dev)
        (h1, e1, s1, _), ms = timed(lambda: be.replay(st, ch, e, hierarchy=h,
                                                      ttls=tt))
        t0 = time.perf_counter()
        h2, e2, s2, _ = hierarchy.replay_l1_over_l2(cfg, h, to_cpu(st), ch, e,
                                                    ttls=tt)
        plain_ms = (time.perf_counter() - t0) * 1e3
        d = max_abs_err([(h1, h2), (e1, e2)] + hier_pairs(s1, s2))
        if d:
            raise AssertionError(f"replay_hierarchical {cfg.policy.name} "
                                 f"{label}: != plain version (err {d})")
        err = max(err, d)
        n = int(e.sum())
        say(card, f"kernel 4 == plain version (CPU tensors): "
                  f"{cfg.policy.name} L1 {h.l1_sets}x{h.l1_ways} over L2 "
                  f"{cfg.num_sets}x{cfg.ways}, {label}, n={n} "
                  f"B={ch.shape[1]} ttl={tt is not None}: hits "
                  f"{int(h1.sum())} evictions {int(e1.sum())}, L1 occupancy "
                  f"{int(s1.l1.occupancy())} (kernel {ms:.3f} ms by CUDA "
                  f"events, plain {plain_ms:.1f} ms host wall)")
        if k == 0:
            qk = hashing.key_tensor(ch, dev)
            qe = torch.from_numpy(e).to(dev)
            run = lambda: krp.replay_hierarchical(  # noqa: E731
                cfg, h, st, qk, qe)
            k_ms = cuda_ms(run, 3)
            dev_ms = profiled_device_ms(run, 1, ("hier_kernel",))
            b = hier_bound_bytes(cfg, h, st, s1, qk, qe)
            results["replay_hierarchical"].update(
                ms=k_ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b / HBM_BYTES_PER_S * 1e3, requests=n)
            say(card, f"replay_hierarchical {cfg.policy.name} {label}, n={n}"
                      f" B={ch.shape[1]}: {k_ms:.3f} ms/launch (CUDA "
                      f"events, mean of 3), device time {fmt_ms(dev_ms)} "
                      f"(torch.profiler), bound "
                      f"{b / HBM_BYTES_PER_S * 1e3:.6f} ms ({b} B), plain "
                      f"version on CPU tensors {plain_ms:.1f} ms (host wall, "
                      f"one run); library_ms: none")
    results["replay_hierarchical"]["max_abs_err"] = err


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


def phase_slice_records(card, dev):
    """The 4 resident-eq/*/tinylfu and 6 hier-hr/* committed hit ratios,
    exactly (figures.py's configurations)."""
    from repro_torch.core import admission, simulate, trace_io, traces
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    def records(name, prefix):
        with open(os.path.join(BASELINES, name)) as f:
            return [r for r in json.load(f)["records"]
                    if r["id"].startswith(prefix)]

    bad = []
    tl = admission.for_capacity(1024)
    recs = [r for r in records("BENCH_throughput_resident_quick.json",
                               "resident-eq/") if r["admission"] == "tinylfu"]
    for r in recs:
        cfg = KWayConfig(num_sets=128, ways=8,
                         policy=Policy.parse(r["policy"]))
        sim = simulate.SimConfig(cfg, tinylfu=tl, backend="cuda", device=dev)
        got = simulate.replay_batched(
            sim, traces.generate(r["family"], r["n"], seed=42),
            batch=r["batch"], resident=True)
        if got != r["value"]:
            bad.append((r["id"], got, r["value"]))
    trace_io.register_fixture_traces()
    hrecs = records("BENCH_throughput_hierarchy_quick.json", "hier-hr/")
    sim = simulate.SimConfig(KWayConfig(num_sets=64, ways=8), backend="cuda",
                             device=dev)
    for r in hrecs:
        kw = {"catalog": 4096} if r["family"] == "zipf" else {}
        got = simulate.replay_batched(
            sim, traces.generate(r["family"], r["n"], seed=7, **kw),
            batch=r["batch"], hierarchy=HierarchyConfig(
                l1_sets=r["l1_sets"], l1_ways=r["l1_ways"]))
        if got != r["value"]:
            bad.append((r["id"], got, r["value"]))
    if len(recs) != 4 or len(hrecs) != 6 or bad:
        raise AssertionError(f"{len(recs)} TinyLFU and {len(hrecs)} "
                             f"hierarchy records; differing: {bad}")
    say(card, "4/4 resident-eq/*/tinylfu and 6/6 hier-hr/* committed hit "
              "ratios reproduced exactly (cuda backend, replay_batched "
              "resident=True / hierarchy=...)")


KERNELS = ("kway_probe", "kway_fused_probe", "replay_resident",
           "replay_resident_tinylfu", "replay_hierarchical", "paged_attention")


def launch_counts() -> dict:
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import replay as krp
    return {"kway_probe": kp.LAUNCHES["kway_probe"],
            "kway_fused_probe": kp.LAUNCHES["kway_fused_probe"],
            "replay_resident": krp.launches("flat"),
            "replay_resident_tinylfu": krp.launches("tinylfu"),
            "replay_hierarchical": krp.launches("hier"),
            "paged_attention": kpa.LAUNCHES["paged_attention"]}


def check_launches(card, path, kernels, results):
    """Fail unless each kernel of ``path`` ran since the counters were set
    to 0; add the counts to the kernels' main-path launches."""
    counts = launch_counts()
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path: {counts}")
    for name, c in counts.items():
        results[name]["launches"] = results[name].get("launches", 0) + c
    say(card, f"main path ({path}) launches: {counts}")


def reset_launch_counts():
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import replay as krp
    for k in kp.LAUNCHES:
        kp.LAUNCHES[k] = 0
    kpa.LAUNCHES["paged_attention"] = 0
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
        results["replay_resident"].setdefault("hit_ratio", {})[name] = \
            ratios["resident"]
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
    check_launches(card, "flat", ("kway_probe", "kway_fused_probe",
                                  "replay_resident"), results)


def phase_main_path_tinylfu(card, trace, dev, results):
    """The TinyLFU path through ``replay_batched``, resident and chunked, on
    the first PREFIX requests (the chunked form is host-bound), counted."""
    from repro_torch.core import admission, simulate
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    tl = admission.for_capacity(NUM_SETS * WAYS)
    reset_launch_counts()
    for name in TL_POLICIES:
        sim = simulate.SimConfig(
            KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                       policy=Policy.parse(name)),
            tinylfu=tl, backend="cuda", device=dev)
        ratios = {form: simulate.replay_batched(
            sim, trace[:PREFIX], batch=BATCH, resident=form == "resident")
            for form in ("resident", "chunked")}
        if len(set(ratios.values())) != 1:
            raise AssertionError(f"TinyLFU {name}: replay forms disagree: "
                                 f"{ratios}")
        say(card, f"main path TinyLFU {name}, first {PREFIX} requests: hit "
                  f"ratio {ratios['resident']!r} (resident == chunked)")
    check_launches(card, "TinyLFU", ("kway_probe", "kway_fused_probe",
                                     "replay_resident_tinylfu"), results)


def phase_main_path_hier(card, trace, ttl_trace, dev, results):
    """The hierarchy through ``replay_batched(hierarchy=...)`` at full depth
    (LRU, HYPERBOLIC) and with TTLs, counted; its hit ratio beside the flat
    cache's."""
    from repro_torch.core import simulate
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    hc = HierarchyConfig(l1_sets=HIER_L1_SETS, l1_ways=HIER_L1_WAYS)
    flat = results["replay_resident"]["hit_ratio"]
    reset_launch_counts()
    for name in HIER_POLICIES:
        sim = simulate.SimConfig(
            KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                       policy=Policy.parse(name)), backend="cuda", device=dev)
        t0 = time.perf_counter()
        hr = simulate.replay_batched(sim, trace, batch=BATCH, hierarchy=hc)
        wall = time.perf_counter() - t0
        say(card, f"main path hierarchy {name}: L1 {HIER_L1_SETS}x"
                  f"{HIER_L1_WAYS} over L2 {NUM_SETS}x{WAYS} (total "
                  f"{NUM_SETS * WAYS + hc.l1_capacity} entries): hit ratio "
                  f"{hr!r}, flat {NUM_SETS}x{WAYS}: {flat[name]!r} "
                  f"({wall:.1f} s host wall)")
    keys, ttls = ttl_trace
    hct = HierarchyConfig(l1_sets=HIER_TTL_L1_SETS, l1_ways=HIER_L1_WAYS)
    sim = simulate.SimConfig(KWayConfig(num_sets=TTL_SETS, ways=WAYS),
                             backend="cuda", device=dev)
    hr = simulate.replay_batched(sim, keys, batch=TTL_BATCH, hierarchy=hct,
                                 ttls=ttls)
    say(card, f"main path hierarchy TTL (ttl_churn, L1 {HIER_TTL_L1_SETS}x"
              f"{HIER_L1_WAYS} over L2 {TTL_SETS}x{WAYS}): hit ratio {hr!r}")
    check_launches(card, "hierarchy", ("replay_hierarchical",), results)


def time_hier_trace(cfg, hc, hst, qkeys, enabled):
    """Kernel 4 over a whole trace from ``hst``: (its outputs, ms of one
    launch by CUDA events, device ms of a second launch by torch.profiler).
    No warm-up call."""
    from repro_torch.kernels import replay as krp

    run = lambda: krp.replay_hierarchical(cfg, hc, hst, qkeys,  # noqa: E731
                                          enabled)
    out, ms = timed(run)
    return out, ms, profiled_device_ms(run, 1, ("hier_kernel",),
                                       warmup=False)


def time_replay_trace(cfg, st0, qkeys, enabled, tinylfu=None, reps=5):
    """Kernel 3 over a whole trace from ``st0``: (its outputs, mean ms per
    wrapper call by CUDA events over ``reps`` calls after a warm-up, device
    ms of one call's kernel-3 kernels by torch.profiler)."""
    from repro_torch.kernels import replay as krp

    run = lambda: krp.replay_resident(cfg, st0, qkeys,  # noqa: E731
                                      enabled, tinylfu=tinylfu)
    out = run()
    ms = cuda_ms(run, reps, warmup=False)
    return out, ms, profiled_device_ms(run, 1, KERNEL3_NAMES, warmup=False)


def time_bucketing(cfg, qkeys, enabled, reps=5):
    """Kernel 3's bucketing alone on a trace: (ms per call by CUDA events,
    device ms by torch.profiler)."""
    from repro_torch.core import kway
    from repro_torch.kernels import replay as krp

    qk, sets = kway.route(cfg, qkeys.reshape(-1))
    qk = qk.view(qkeys.shape)
    sets = sets.to(torch.int32).view(qkeys.shape)
    run = lambda: krp.bucket_lanes(qk, sets, enabled,  # noqa: E731
                                   cfg.num_sets)
    return cuda_ms(run, reps), profiled_device_ms(run, 1, ("bucket_",))


def kernel_grids(fn, name) -> list:
    """Grid sizes (blocks) of the launches of kernels whose names contain
    ``name`` in one call of ``fn``, from torch.profiler's trace ([]: the
    trace carries no grid)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    grids = []
    for ev in events:
        grid = (ev.get("args") or {}).get("grid")
        if name in ev.get("name", "") and grid:
            grids.append(int(np.prod(grid)))
    return grids


def phase_skew_kernel(card, trace, dev, results):
    """Kernel 3 on a skewed full-size trace: the first SKEW_N requests with
    every other one replaced by the first key, so one owner walks every
    chunk with half of its lanes: == the torch twin, exactly (LRU)."""
    from repro_torch.core import router
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy

    tr = np.array(trace[:SKEW_N])
    tr[::2] = tr[0]
    chunks, en = router.pad_chunks(tr, BATCH)
    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    cb = make_backend("cuda", cfg, dev)
    tb = make_backend("torch", cfg, dev)
    got, ms = timed(lambda: cb.replay(cb.init(), chunks, en))
    want, plain = timed(lambda: tb.replay(tb.init(), chunks, en))
    d = max_abs_err([(got[0], want[0]), (got[1], want[1])]
                    + state_pairs(got[2], want[2]))
    if d:
        raise AssertionError(f"replay_resident skew: != torch twin (err {d})")
    say(card, f"kernel 3 == torch twin on the skewed trace (LRU S={NUM_SETS} "
              f"ways={WAYS}, n={SKEW_N}, B={BATCH}, every other request key "
              f"{int(tr[0])}): hits {int(got[0].sum())} evictions "
              f"{int(got[1].sum())} (CUDA events: kernel {ms:.3f} ms, twin "
              f"{plain:.3f} ms)")
    results["replay_resident"]["skew_ms"] = ms


def phase_timing(card, trace, dev, results):
    """CUDA-event times of each kernel and its plain version at full size."""
    from repro_torch.core import admission, hashing, hierarchy, kway, router
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import kway_probe as kp
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import replay as krp

    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    st = fill_state(cfg, router.pad_chunks(trace[:PREFIX], BATCH), dev)
    q = hashing.key_tensor(trace[PREFIX:PREFIX + BATCH], dev)
    en = torch.ones(BATCH, dtype=torch.bool, device=dev)
    lanes = (st.keys, st.fprint, st.meta_a, st.meta_b)
    route = dict(num_sets=cfg.num_sets, seed=cfg.seed, policy=cfg.policy)
    row = WAYS * 4
    rows = int(torch.unique(kway.route(cfg, q)[1]).numel())

    # kernel 1, full-order variant (the put probe of the two-phase path):
    # reads the raw keys (4 B a query), the clock and lanes_read rows per
    # distinct set; writes the key, set, hit, way, victim way and key and
    # the order, at the reference's widths (4 + 4 + 1 + 4 + 4 + 4 + 4*ways
    # B a query; the wrapper's int64 sets and ways are the design's cost,
    # not the bound's)
    k1 = dict(route, full_order=True)
    b1 = (rows * lanes_read(Policy.LRU) * row + 4
          + BATCH * (4 + 4 + 4 + 1 + 4 + 4 + 4 + row))
    run1 = lambda: kp.kway_probe(*lanes, q, st.clock, **k1)  # noqa: E731
    ms = cuda_ms(run1, 200)
    plain = cuda_ms(lambda: kref.kway_probe_ref(*lanes, q, st.clock, **k1),
                    50)
    dev_ms = profiled_device_ms(run1, 50, ("probe_kernel",))
    ops_ms = cuda_ms(lambda: ops.probe_orders(cfg, st, q), 200)
    ops_host = host_us(lambda: ops.probe_orders(cfg, st, q))
    bound = b1 / HBM_BYTES_PER_S * 1e3
    results["kway_probe"].update(
        ms=ms, plain_ms=plain, device_ms=dev_ms, bound_ms=bound,
        bound_share=dev_ms and bound / dev_ms, ops_ms=ops_ms,
        ops_host_us=ops_host)
    kh = dict(route, need_victims=False)
    ms_h = cuda_ms(lambda: kp.kway_probe(*lanes, q, st.clock, **kh), 200)
    say(card, f"kway_probe full_order B={BATCH}: {ms:.4f} ms per wrapper "
              f"call (CUDA events, back to back), kernel device time "
              f"{fmt_ms(dev_ms)} (torch.profiler), bound {bound:.6f} ms "
              f"({b1} B), bound share {fmt_share(dev_ms and bound / dev_ms)},"
              f" plain {plain:.4f} ms; ops.probe_orders {ops_ms:.4f} ms per "
              f"call (CUDA events), host {ops_host:.1f} us per call; "
              f"hits-only variant {ms_h:.4f} ms per call; library_ms: none")
    say_previous(card, "kway_probe")

    # kernel 2: reads the raw keys and enable flags (5 B a query), the clock
    # and lanes_read rows per distinct set; writes the key, set, hit, way
    # and the order at the reference's widths (4 + 4 + 1 + 4 + 4*ways B a
    # query)
    b2 = (rows * lanes_read(Policy.LRU) * row + 4
          + BATCH * (5 + 4 + 4 + 1 + 4 + row))
    run2 = lambda: kp.kway_fused_probe(*lanes, q, st.clock, en,  # noqa: E731
                                       **route)
    ms = cuda_ms(run2, 200)
    plain = cuda_ms(lambda: kref.kway_fused_probe_ref(*lanes, q, st.clock,
                                                      en, **route), 50)
    dev_ms = profiled_device_ms(run2, 50, ("fused_kernel",))
    ops_ms = cuda_ms(lambda: ops.fused_probe(cfg, st, q, en), 200)
    ops_host = host_us(lambda: ops.fused_probe(cfg, st, q, en))
    bound = b2 / HBM_BYTES_PER_S * 1e3
    results["kway_fused_probe"].update(
        ms=ms, plain_ms=plain, device_ms=dev_ms, bound_ms=bound,
        bound_share=dev_ms and bound / dev_ms, ops_ms=ops_ms,
        ops_host_us=ops_host)
    say(card, f"kway_fused_probe B={BATCH}: {ms:.4f} ms per wrapper call "
              f"(CUDA events), device time {fmt_ms(dev_ms)} (torch.profiler,"
              f" one kernel), bound {bound:.6f} ms ({b2} B), bound share "
              f"{fmt_share(dev_ms and bound / dev_ms)}, plain {plain:.4f} "
              f"ms; ops.fused_probe {ops_ms:.4f} ms per call (CUDA events), "
              f"host {ops_host:.1f} us per call; library_ms: none")
    say_previous(card, "kway_fused_probe")
    split = probe_split(cfg, st, q, en)
    say_split(card, split, "one launch per ops call")
    for name, key in (("probe_orders", "kway_probe"),
                      ("fused_probe", "kway_fused_probe")):
        results[key]["split_us"] = split[name]
    probe_at_scale(card, cfg, st, trace, dev, results)

    # kernel 3: the whole trace; reads the trace (4 B key + 1 B flag per
    # request) and, of each row the trace touches, the lanes its policy
    # reads; writes the 5 lanes of the state it returns and 8 B per chunk
    chunks, en_c = router.pad_chunks(trace, BATCH)
    qkeys = hashing.key_tensor(chunks, dev)
    enabled = torch.from_numpy(en_c).to(dev)
    n = len(trace)
    for name in MAIN_POLICIES:
        cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                         policy=Policy.parse(name))
        be = make_backend("cuda", cfg, dev)
        st0 = be.init()
        touched = int(torch.unique(
            kway.route(cfg, qkeys.reshape(-1)[enabled.reshape(-1)])[1]).numel())
        b3 = (qkeys.numel() * 5 + touched * lanes_read(cfg.policy) * row
              + len(kway.STATE_LANES) * NUM_SETS * row + 8 * chunks.shape[0])
        _, ms, dev_ms = time_replay_trace(cfg, st0, qkeys, enabled)
        bucket_ms, bucket_dev = time_bucketing(cfg, qkeys, enabled)
        bound = b3 / HBM_BYTES_PER_S * 1e3
        line = (f"replay_resident {name} n={n} B={BATCH}, owners form: "
                f"{ms:.3f} ms per call (CUDA events, mean of 5; "
                f"{n / ms * 1e3:.0f} requests/s), device time "
                f"{fmt_ms(dev_ms)} (torch.profiler, bucketing + replay "
                f"kernels), bound {bound:.4f} ms ({b3} B; {touched} of "
                f"{NUM_SETS} sets touched), bound share "
                f"{fmt_share(dev_ms and bound / dev_ms)}; bucketing alone "
                f"{bucket_ms:.3f} ms per call ({bucket_ms / ms:.1%} of the "
                f"call), device {fmt_ms(bucket_dev)}")
        if name != "LRU":
            say(card, line + "; library_ms: none")
            continue
        # the host-bound plain and chunked replays are timed for LRU only;
        # both ran at this size in phase_replay_kernel: no warm-up call
        plain = cuda_ms(lambda: krp.replay_ref(cfg, st0, qkeys, enabled), 1,
                        warmup=False)
        chunked = cuda_ms(lambda: be.replay_scan(st0, chunks, en_c), 1,
                          warmup=False)
        grids = kernel_grids(lambda: krp.replay_resident(cfg, st0, qkeys,
                                                         enabled),
                             "owners_kernel")
        if grids and max(grids) <= 1:
            raise AssertionError(f"owners form ran on grid {grids}")
        say(card, line + f"; owners kernel grid {grids or 'not in the trace'}"
                  f" blocks of {krp.num_owners(NUM_SETS)} owners; plain "
                  f"(torch twin) {plain:.3f} ms ({n / plain * 1e3:.0f} "
                  f"requests/s), cuda chunked path {chunked:.3f} ms "
                  f"({n / chunked * 1e3:.0f} requests/s); library_ms: none")
        say_previous(card, "replay_resident")
        chunked_busy_share(card, be, st0, chunks[:64], en_c[:64])
        results["replay_resident"].update(
            ms=ms, plain_ms=plain, device_ms=dev_ms, bound_ms=bound,
            bucket_ms=bucket_ms, bucket_device_ms=bucket_dev,
            blocks=grids[0] if grids else None, form="owners",
            requests_per_s=n / ms * 1e3)
        b3_lru = b3

    # kernel 3's TinyLFU branch (LRU, for_capacity(2^20)): kernel 3's bytes
    # plus each sketch word the trace touches (counter words of the 4 rows,
    # door words) read once and written once, and the additions word
    tl = admission.for_capacity(NUM_SETS * WAYS)
    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    st0 = kway.make_cache(cfg, device=dev)
    live = hashing.sanitize_keys(qkeys.reshape(-1)[enabled.reshape(-1)])
    uniq = torch.unique(live)
    word, _ = admission._positions(tl, uniq)
    rows = torch.arange(admission.ROWS, device=dev)[:, None]
    cwords = int(torch.unique(rows * (tl.width // 8) + word).numel())
    dwords = int(torch.unique(admission._door_pos(tl, uniq)[0]).numel())
    bt = b3_lru + 2 * 4 * (cwords + dwords + 1)
    form = krp.replay_form(BATCH, True)
    _, ms, dev_ms = time_replay_trace(cfg, st0, qkeys, enabled, tinylfu=tl)
    bucket_ms = results["replay_resident"]["bucket_ms"]
    grids = kernel_grids(lambda: krp.replay_resident(cfg, st0, qkeys, enabled,
                                                     tinylfu=tl),
                         "grid_kernel")
    bound = bt / HBM_BYTES_PER_S * 1e3
    r = results["replay_resident_tinylfu"]
    r.update(ms=ms, device_ms=dev_ms, bound_ms=bound, form=form,
             blocks=grids[0] if grids else None,
             bucket_share=bucket_ms / ms, requests_per_s=n / ms * 1e3)
    say(card, f"replay_resident TinyLFU LRU n={n} B={BATCH}, {form} form: "
              f"{ms:.3f} ms per call (CUDA events, mean of 5; "
              f"{n / ms * 1e3:.0f} requests/s), device time {fmt_ms(dev_ms)} "
              f"(torch.profiler), grid {grids or 'not in the trace'} blocks, "
              f"bound {bound:.4f} ms ({bt} B; {cwords} counter and {dwords} "
              f"door words touched), bound share "
              f"{fmt_share(dev_ms and bound / dev_ms)}, bucketing (timed "
              f"above) {bucket_ms / ms:.1%} of the call; plain (torch twin, "
              f"phase 4) {r['plain_ms']:.3f} ms "
              f"({n / r['plain_ms'] * 1e3:.0f} requests/s), cuda chunked "
              f"path {r['chunked_ms']:.3f} ms "
              f"({n / r['chunked_ms'] * 1e3:.0f} requests/s); hit ratio "
              f"{r['hit_ratio']!r}; library_ms: none")
    say_previous(card, "replay_resident_tinylfu")

    # the TinyLFU forms at narrow chunks: grid against block, equal
    narrow = {}
    rule = krp.TL_GRID_MIN_BATCH
    try:
        for b in TL_NARROW_BATCHES:
            nch, nen = router.pad_chunks(trace[:TL_NARROW_N], b)
            nq = hashing.key_tensor(nch, dev)
            ne = torch.from_numpy(nen).to(dev)
            outs, times = {}, {}
            for f, limit in (("grid", 1), ("block", krp.MAX_BATCH + 1)):
                krp.TL_GRID_MIN_BATCH = limit
                outs[f], f_ms, f_dev = time_replay_trace(cfg, st0, nq, ne,
                                                         tinylfu=tl, reps=2)
                times[f] = (f_ms, f_dev)
            g, k = outs["grid"], outs["block"]
            d = max_abs_err([(g[0], k[0]), (g[1], k[1])]
                            + state_pairs(g[2], k[2]) + sketch_pairs(g[3], k[3]))
            if d:
                raise AssertionError(f"TinyLFU grid form != block form at "
                                     f"B={b} (err {d})")
            narrow[b] = {f: t[0] for f, t in times.items()}
            say(card, f"replay_resident TinyLFU forms, first {TL_NARROW_N} "
                      f"requests at B={b}: grid {times['grid'][0]:.3f} ms per "
                      f"call (device {fmt_ms(times['grid'][1])}), block "
                      f"{times['block'][0]:.3f} ms (device "
                      f"{fmt_ms(times['block'][1])}); equal exactly; the rule "
                      f"runs {'grid' if b >= rule else 'block'}")
    finally:
        krp.TL_GRID_MIN_BATCH = rule
    r["narrow_ms"] = narrow

    # kernel 4 over the whole trace (LRU, L1 512 x 16 over the empty L2),
    # bounded as in phase_hier_kernel; its plain version walks lanes one at
    # a time and is timed on that phase's 2^14-request inputs only
    hc = hierarchy.HierarchyConfig(l1_sets=HIER_L1_SETS,
                                   l1_ways=HIER_L1_WAYS)
    hst = hierarchy.make_hier(cfg, hc, device=dev)
    form = krp.hier_l1_form(cfg, hc, False, dev)
    if form != "shared":
        raise AssertionError(f"L1 {HIER_L1_SETS}x{HIER_L1_WAYS} runs in the "
                             f"{form} form, not in shared memory")
    # the main path ran it at this size: no warm-up call
    (hh, he, hout, _), ms, dev_ms = time_hier_trace(cfg, hc, hst, qkeys,
                                                    enabled)
    bh = hier_bound_bytes(cfg, hc, hst, hout, qkeys, enabled)
    r = results["replay_hierarchical"]
    r.update(full_requests=n, full_ms=ms, full_device_ms=dev_ms,
             full_bound_ms=bh / HBM_BYTES_PER_S * 1e3,
             full_ns_per_request=(ms if dev_ms is None else dev_ms) * 1e6 / n)
    say(card, f"replay_hierarchical LRU whole trace n={n} B={BATCH}, L1 in "
              f"shared memory: {ms:.3f} ms/launch ({n / ms * 1e3:.0f} "
              f"requests/s, {ms * 1e6 / n:.1f} ns per request), device time "
              f"{fmt_ms(dev_ms)} (torch.profiler), bound "
              f"{bh / HBM_BYTES_PER_S * 1e3:.4f} ms ({bh} B); plain version: "
              f"timed on the {HIER_CHECK_N}-request inputs only; "
              f"library_ms: none")
    say_previous(card, "replay_hierarchical")

    # the global form over the whole trace: the same hierarchy with the
    # shared form ruled out (the size limit read as 0 bytes), equal to the
    # shared-memory run bit for bit
    optin = krp._smem_optin
    krp._smem_optin = lambda device: 0
    try:
        krp.reset_trace_counts()
        (gh, ge, gout, _), g_ms, g_dev = time_hier_trace(cfg, hc, hst, qkeys,
                                                         enabled)
        forms = {key[-1] for key in krp.trace_counts()}
    finally:
        krp._smem_optin = optin
    d = max_abs_err([(gh, hh), (ge, he)] + hier_pairs(gout, hout))
    if d or forms != {"global"}:
        raise AssertionError(f"global-L1 form ({forms}) != shared-memory "
                             f"form over the whole trace (err {d})")
    # an L1 too large for shared memory: global by size, over the same L2;
    # its first HIER_CHECK_N requests == the plain version
    hbig = hierarchy.HierarchyConfig(l1_sets=HIER_GLOBAL_L1_SETS,
                                     l1_ways=HIER_L1_WAYS)
    ring, l1_bytes = krp.hier_smem_bytes(cfg, hbig, False)
    if krp.hier_l1_form(cfg, hbig, False, dev) != "global":
        raise AssertionError("the large L1 fits shared memory")
    bst = hierarchy.make_hier(cfg, hbig, device=dev)
    _, big_ms = timed(lambda: krp.replay_hierarchical(cfg, hbig, bst, qkeys,
                                                      enabled))
    m = HIER_CHECK_N // BATCH
    k_out = krp.replay_hierarchical(cfg, hbig, bst, qkeys[:m], enabled[:m])
    p_out = hierarchy.replay_l1_over_l2(cfg, hbig, to_cpu(bst), chunks[:m],
                                        en_c[:m])
    d = max_abs_err([(k_out[0], p_out[0]), (k_out[1], p_out[1])]
                    + hier_pairs(k_out[2], p_out[2]))
    if d:
        raise AssertionError(f"global-L1 form, L1 {HIER_GLOBAL_L1_SETS}x"
                             f"{HIER_L1_WAYS}: != plain version (err {d})")
    r.update(global_forced_ms=g_ms, global_forced_device_ms=g_dev,
             global_l1=f"{HIER_GLOBAL_L1_SETS}x{HIER_L1_WAYS}",
             global_ms=big_ms)
    say(card, f"replay_hierarchical global-L1 form, whole trace: L1 "
              f"{HIER_L1_SETS}x{HIER_L1_WAYS} with shared memory ruled out "
              f"== the shared-memory run exactly (hits, evictions, both "
              f"tiers), {g_ms:.3f} ms/launch, device time {fmt_ms(g_dev)}; "
              f"L1 {HIER_GLOBAL_L1_SETS}x{HIER_L1_WAYS} ({l1_bytes} B + "
              f"{ring} B ring > the {optin(dev)} B opt-in) runs global by "
              f"size: {big_ms:.3f} ms/launch ({big_ms * 1e6 / n:.1f} ns per "
              f"request); its first {HIER_CHECK_N} requests ({int(k_out[0].sum())}"
              f" hits) == plain version exactly")


# ---------------------------------------------------------------------------
# serving slice: the paged engine at deepseek-7b's width and kernel 5
# ---------------------------------------------------------------------------

def serve_config():
    """The model of the serving phases (a hook for CPU rehearsals)."""
    from repro_torch import configs
    return configs.get(SERVE_ARCH).config


def say_serve_config(card):
    cfg = serve_config()
    e = SERVE_ENGINE
    pages = e["num_sets"] * e["ways"] + e["private_pages"]
    pool = cfg.num_layers * cfg.num_kv_heads * pages * e["page"] * cfg.hd * 2
    say(card, f"serving config: {cfg.name} at full width, {cfg.num_layers} "
              f"layers, d {cfg.d_model}, {cfg.num_heads} heads x {cfg.hd} "
              f"({cfg.num_kv_heads} KV heads), d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}: {cfg.param_count()} bf16 parameters "
              f"({2 * cfg.param_count()} B), random from torch.Generator "
              f"seed 0")
    say(card, f"serving config: EngineConfig({', '.join(f'{k}={v}' for k, v in e.items())}, "
              f"policy=LRU): {e['num_sets'] * e['ways']} shared + "
              f"{e['private_pages']} private = {pages} pages; K and V pools "
              f"each [{cfg.num_layers}, {cfg.num_kv_heads}, {pages}, "
              f"{e['page']}, {cfg.hd}] bf16 = {pool} B")
    say(card, f"serving config: {SERVE_REQUESTS} requests, a shared "
              f"{SERVE_SHARED}-token prefix + a {SERVE_TAIL[0]}-"
              f"{SERVE_TAIL[1]}-token tail each (default_rng(0)), max_new "
              f"{SERVE_MAX_NEW}, greedy; backends cuda then torch")


def serve_traffic(vocab: int) -> list:
    """SERVE_REQUESTS prompts: one shared SERVE_SHARED-token prefix plus a
    tail of SERVE_TAIL tokens each, from default_rng(0) over [2, vocab-1)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(2, vocab - 1, SERVE_SHARED)
    lo, hi = SERVE_TAIL
    return [np.concatenate([shared, rng.integers(
        2, vocab - 1, int(rng.integers(lo, hi + 1)))])
        for _ in range(SERVE_REQUESTS)]


class CaptureStep:
    """Stands in for ``ops.attend_paged`` while the engine runs: passes every
    call on to the kernel and keeps clones of the inputs of every layer's
    call in decode step ``step``."""

    def __init__(self, layers: int, step: int):
        from repro_torch.kernels import ops
        self.ops, self.kernel = ops, ops.attend_paged
        self.layers, self.step, self.calls, self.inputs = layers, step, 0, []

    def __enter__(self):
        self.ops.attend_paged = self
        return self

    def __exit__(self, *exc):
        self.ops.attend_paged = self.kernel

    def __call__(self, q, k_pages, v_pages, page_table, seq_lens, **kw):
        if self.calls // self.layers == self.step:
            self.inputs.append(tuple(t.clone() for t in (
                q, k_pages, v_pages, page_table, seq_lens)) + (kw,))
        self.calls += 1
        return self.kernel(q, k_pages, v_pages, page_table, seq_lens, **kw)


class SampleRecorder:
    """Stands in for the engine module's ``_argmax`` / ``_sample_next``
    during a host-loop run (``attach`` takes the engine): keeps the float32
    logits behind every token, keyed by (request id, token index), with the
    decode step and slot of each decode token (the Gumbel noise's key and
    row).  The copies stay on the engine's device, so a timed run is not
    held up by them."""

    def __init__(self):
        from repro_torch.serve import engine as teng
        self.teng, self.engine = teng, None
        self.prefill, self.decode = [], {}

    def attach(self, eng):
        self.engine = eng

    def __enter__(self):
        teng = self.teng
        self.real = (teng._argmax, teng._sample_next)
        real_argmax, real_sample = self.real

        def argmax(logits):
            if logits.dim() == 1:          # a host-loop prefill, in rid order
                self.prefill.append(logits.float().clone())
            return real_argmax(logits)

        def sample(ecfg, logits, step):
            lg = logits.float().clone()
            for slot, r in enumerate(self.engine.slots):
                if r is not None and not r.done:
                    self.decode[(r.rid, len(r.generated))] = (lg, int(step),
                                                              slot)
            return real_sample(ecfg, logits, step)

        teng._argmax, teng._sample_next = argmax, sample
        return self

    def __exit__(self, *exc):
        self.teng._argmax, self.teng._sample_next = self.real

    def scores_of(self, rid: int, i: int):
        """What the host loop's token i of ``rid`` was the argmax of, on
        the CPU: (the float32 logits, the scores, their scale) -- the
        scores are the logits (a prefill's first token, or at temperature
        0), else the logits over T plus the Gumbel noise of that decode
        step and slot, scale 1/T."""
        from repro_torch.core import prng
        ecfg = self.engine.ecfg
        if i == 0:
            lg = self.prefill[rid].cpu()
            return lg, lg, 1.0
        lg, step, slot = self.decode[(rid, i)]
        lg = lg.cpu()
        if ecfg.temperature <= 0:
            return lg[slot], lg[slot], 1.0
        key = prng.fold_in(prng.prng_key(ecfg.sample_seed), step)
        scores = lg / torch.full_like(lg, ecfg.temperature) \
            + prng.gumbel(key, tuple(lg.shape))
        return lg[slot], scores[slot], 1.0 / ecfg.temperature


def check_tick_tokens(rec, host_reqs, tick_reqs):
    """The tick's tokens against the host loop's (recorded by ``rec``),
    one rule for every serving phase.  Per request: equal token counts and
    prefix hits; tokens equal, or at the first divergence the two tokens
    tie within 3e-2 (bf16: the tick prefills ``max_batch`` lanes at once,
    the host loop one) in the scores the host loop drew that token from,
    the tolerance scaled with them -> (requests equal throughout, the
    largest gap at a divergence)."""
    equal, gap = 0, 0.0
    for rid, (htoks, _, hph) in host_reqs.items():
        ttoks, tph = tick_reqs[rid]
        if len(ttoks) != len(htoks) or tph != hph:
            raise AssertionError(f"request {rid}: {len(ttoks)} tokens, "
                                 f"{tph} prefix hits on the tick; "
                                 f"{len(htoks)}, {hph} on the host loop")
        diff = [i for i, (a, b) in enumerate(zip(htoks, ttoks)) if a != b]
        if not diff:
            equal += 1
            continue
        i = diff[0]
        lg, score, scale = rec.scores_of(rid, i)
        a, b = htoks[i], ttoks[i]
        tol = (3e-2 + 3e-2 * abs(float(lg[a]))) * scale
        d = float((score[a] - score[b]).abs())
        if d > tol:
            raise AssertionError(f"request {rid} token {i}: {a} (host loop) "
                                 f"vs {b} (tick) is no bf16 tie: {d} > {tol}")
        gap = max(gap, d)
    return equal, gap


def drive_engine(cfg, model, backend, prompts, dev, max_new=None,
                 recorder=None, **kw):
    """Submit the prompts (``max_new`` None: SERVE_MAX_NEW), ``Engine.run``
    on ``backend`` (the host loop; ``kw`` overrides SERVE_ENGINE; an
    entered SampleRecorder ``recorder`` records the run) -> (stats, {rid:
    (tokens, pages, prefix_hits)}, host seconds of run, hit ratio)."""
    from repro_torch.core.policies import Policy
    from repro_torch.serve.engine import Engine, EngineConfig
    eng = Engine(cfg, model, EngineConfig(policy=Policy.LRU, backend=backend,
                                          **dict(SERVE_ENGINE, **kw)),
                 device=dev)
    if recorder is not None:
        recorder.attach(eng)
    for p in prompts:
        eng.submit(p, max_new=max_new or SERVE_MAX_NEW)
    sync(dev)
    t0 = time.perf_counter()
    fin = eng.run()
    sync(dev)
    wall = time.perf_counter() - t0
    reqs = {rid: (r.generated, r.pages, r.prefix_hits)
            for rid, r in fin.items()}
    return eng.stats, reqs, wall, eng.hit_ratio()


def serve_busy_share(card, cfg, model, prompts, dev):
    """Where the serving time goes: one wave (``max_batch`` requests,
    SERVE_PROFILE_MAX_NEW new tokens each) on the ``cuda`` backend, first
    unprofiled (its host wall), then under torch.profiler: device busy over
    the unprofiled wall (and over the profiled wall, which the profiler
    stretches), the costliest device ops and the costliest host ops (self
    CPU time)."""
    from torch.profiler import ProfilerActivity, profile
    wave = prompts[:SERVE_ENGINE["max_batch"]]
    _, _, plain, _ = drive_engine(cfg, model, "cuda", wave, dev,
                                  SERVE_PROFILE_MAX_NEW)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, reqs, wall, _ = drive_engine(cfg, model, "cuda", wave, dev,
                                         SERVE_PROFILE_MAX_NEW)
    t0 = time.perf_counter()
    dev_ops = device_rows(prof)
    host_ops = [(ev.self_cpu_time_total, ev.key)
                for ev in prof.key_averages()]
    busy_us = sum(t for t, _ in dev_ops)

    def top(ops, n):
        return ", ".join(f"{k[:48]} {t / 1e3:.1f} ms" for t, k in
                         sorted(ops, reverse=True)[:n] if t > 0)

    say(card, f"serving, {len(wave)} requests ({st['prefills']} prefills, "
              f"{st['decode_steps']} decode steps, {SERVE_PROFILE_MAX_NEW} "
              f"new tokens per request): unprofiled wall {plain * 1e3:.1f} "
              f"ms; under torch.profiler device busy {busy_us / 1e3:.1f} ms "
              f"= {busy_us / 1e3 / (plain * 1e3):.1%} of the unprofiled wall "
              f"(of the profiled wall {wall * 1e3:.1f} ms: "
              f"{busy_us / 1e3 / (wall * 1e3):.1%}); top device ops: "
              f"{top(dev_ops, 8)}; top host ops (self CPU): "
              f"{top(host_ops, 8)} (profile read in "
              f"{time.perf_counter() - t0:.1f} s)")


def phase_serve_agreement(card, dev):
    """A small input on the card agrees with the CPU: deepseek-7b's smoke
    config, one padded prefill and one paged decode step (kernel 5 on the
    card, its plain version on the CPU) from the same pools, logits within
    the bf16 tolerance 3e-2."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import paged_model as pm

    cfg = configs.get(SERVE_ARCH).smoke
    cpu = torch.device("cpu")
    rng = np.random.default_rng(1)
    toks = np.zeros((2, 32), np.int32)
    lengths = np.array([29, 11], np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(2, cfg.vocab_size - 1, n)
    shape = (cfg.num_layers, cfg.num_kv_heads, 12, 8, cfg.hd)
    pools = torch.from_numpy(rng.standard_normal((2,) + shape).astype(
        np.float32)).bfloat16()
    pt = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    out = []
    for d in (cpu, dev):
        model = lm.init_params(cfg, seed=0, device=cpu).to(d)
        logits, _, _ = pm.prefill_padded(cfg, model,
                                         torch.from_numpy(toks).to(d),
                                         torch.from_numpy(lengths).to(d))
        pk, pv = (t.clone().to(d) for t in pools)
        dl, _, _ = pm.decode_paged(
            cfg, model, torch.tensor([5, 7], dtype=torch.int32, device=d),
            torch.from_numpy(lengths).to(d), pk, pv, pt.to(d),
            torch.ones(2, dtype=torch.bool, device=d))
        out.append((logits.cpu(), dl.cpu()))
    err = 0.0
    for a, b in zip(*out):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite logits on the card")
        torch.testing.assert_close(b, a, atol=3e-2, rtol=3e-2)
        err = max(err, float((a - b).abs().max()))
    say(card, f"small input agrees: {cfg.name} prefill and paged decode "
              f"logits on the card vs CPU, max abs err {err:.3g} (tol 3e-2)")


def phase_serve_path(card, dev, results, serve):
    """The serving path at full width through ``Engine.submit`` /
    ``Engine.run`` on the ``cuda`` backend, counted; every layer's kernel-5
    inputs of decode step SERVE_CAPTURE_STEP captured for phases below; the
    same run on the ``torch`` backend, exactly equal; the CLI once."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm

    cfg = serve_config()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=0, device=dev)
    sync(dev)
    params = list(model.parameters())
    say(card, f"serving model {cfg.name}: {sum(p.numel() for p in params)} "
              f"parameters ({sum(p.numel() * p.element_size() for p in params)}"
              f" B) made on the card in {time.perf_counter() - t0:.1f} s")
    prompts = serve_traffic(cfg.vocab_size)
    reset_launch_counts()
    with CaptureStep(cfg.num_layers, SERVE_CAPTURE_STEP) as cap, \
            SampleRecorder() as rec:
        st, reqs, wall, hr = drive_engine(cfg, model, "cuda", prompts, dev,
                                          recorder=rec)
    counts = launch_counts()
    want = cfg.num_layers * st["decode_steps"]
    if counts["paged_attention"] != want:
        raise AssertionError(f"paged_attention launched "
                             f"{counts['paged_attention']} times, not "
                             f"{cfg.num_layers} x {st['decode_steps']}")
    check_launches(card, "serving", ("kway_probe", "paged_attention"),
                   results)
    if len(cap.inputs) != cfg.num_layers:
        raise AssertionError(f"captured {len(cap.inputs)} layers of decode "
                             f"step {SERVE_CAPTURE_STEP}")
    vp = lm.padded_vocab(cfg)
    for rid, (toks, pages, _) in reqs.items():
        if len(toks) != SERVE_MAX_NEW + 1 or not all(0 <= t < vp
                                                    for t in toks):
            raise AssertionError(f"request {rid}: tokens {toks}")
    if len(reqs) != SERVE_REQUESTS or st["prefills"] != SERVE_REQUESTS:
        raise AssertionError(f"served {len(reqs)} requests, stats {st}")
    n_tok = sum(len(t) for t, _, _ in reqs.values())
    serve.update(inputs=cap.inputs, stats=st, model=model,
                 prompts=prompts, host=(st, reqs, wall, hr), host_rec=rec)
    results["paged_attention"].update(
        serve_tokens=n_tok, serve_s=wall, serve_tokens_per_s=n_tok / wall,
        serve_hit_ratio=hr, serve_decode_steps=st["decode_steps"])
    say(card, f"main path serving (cuda backend): {len(reqs)} requests, "
              f"{n_tok} tokens in {wall:.3f} s host wall ({n_tok / wall:.1f} "
              f"tokens/s), prefix-cache hit ratio {hr!r}, stats {st}")
    st2, reqs2, wall2, _ = drive_engine(cfg, model, "torch", prompts, dev)
    if (st2, reqs2) != (st, reqs):
        bad = [rid for rid in reqs if reqs[rid] != reqs2.get(rid)]
        raise AssertionError(f"torch backend run differs: stats {st2} vs "
                             f"{st}; requests {bad}")
    say(card, f"torch backend run == cuda backend run: stats, pages, prefix "
              f"hits and tokens of all {len(reqs)} requests ({wall2:.3f} s "
              f"host wall)")
    serve_busy_share(card, cfg, model, prompts, dev)
    t0 = time.perf_counter()
    serve_cli.main(["--backend", "cuda", "--requests", "16"])
    say(card, f"repro_torch.launch.serve.main (smoke config, cuda backend) "
              f"ran in {time.perf_counter() - t0:.1f} s")


#: the serving tick's timing: rounds of host loop / tick / tick / host loop
SERVE_TICK_ROUNDS = 1
#: device kernels of the tick, by a substring of their names in a trace
TICK_KERNELS = {"kway_fused_probe": "fused_kernel",
                "kway_probe": "probe_kernel",
                "paged_attention": "paged_attention_kernel"}


def build_tick(cfg, model, dev, **kw):
    """A device-resident tick engine (``jitted=True``, cuda backend; ``kw``
    overrides SERVE_ENGINE), its capture counts reset just before ->
    (engine, seconds of its warm-up and capture, captures by kind)."""
    from repro_torch.core.policies import Policy
    from repro_torch.serve import engine as teng
    teng.reset_capture_counts()
    sync(dev)
    t0 = time.perf_counter()
    eng = teng.Engine(cfg, model, teng.EngineConfig(
        policy=Policy.LRU, backend="cuda", jitted=True,
        **dict(SERVE_ENGINE, **kw)), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    caps = {k[-1]: v for k, v in teng.capture_counts().items()}
    if sorted(caps) != sorted(teng.KINDS) or any(v != 1 for v in
                                                 caps.values()):
        raise AssertionError(f"tick captures {caps}: want one per kind")
    return eng, build_s, caps


def drive_tick(cfg, model, prompts, dev, max_new=None, profiled=False,
               **kw):
    """``drive_engine`` for the tick: build (warm-up and capture, outside
    the timed run), submit, ``Engine.run`` with
    ``torch.cuda.set_sync_debug_mode("error")`` on everywhere but the one
    fetch per tick (a replay that synchronised would raise) ->
    (stats, {rid: (tokens, prefix_hits)}, host seconds of run, hit ratio,
    dict(build_s, ticks, launches: the tick kernels' launches by name, each
    graph's launches at capture times its replays, and with ``profiled``
    rows: the run's device rows of those kernels, the run under
    torch.profiler, replays only, the build outside it))."""
    from torch.profiler import ProfilerActivity, profile
    eng, build_s, caps = build_tick(cfg, model, dev, **kw)
    for p in prompts:
        eng.submit(p, max_new=max_new or SERVE_MAX_NEW)
    fetch = eng._fetch

    def fetch_synced():
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch()
        finally:
            torch.cuda.set_sync_debug_mode("error")

    eng._fetch = fetch_synced
    sync(dev)
    prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fin = eng.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync(dev)
    wall = time.perf_counter() - t0
    from repro_torch.serve import engine as teng
    if {k[-1]: v for k, v in teng.capture_counts().items()} != caps:
        raise AssertionError("the tick captured again during its run")
    reqs = {rid: (r.generated, r.prefix_hits) for rid, r in fin.items()}
    # each replay launches every kernel its graph holds, as the wrappers
    # counted them at capture
    info = dict(build_s=build_s, ticks=dict(eng.ticks), launches={
        k: sum(eng.graph_launches[kind].get(k, 0) * n
               for kind, n in eng.ticks.items()) for k in TICK_KERNELS})
    if profiled:
        rows = tick_rows(prof)
        info["rows"] = {k: sum(c for key, c, _ in rows if sub in key)
                        for k, sub in TICK_KERNELS.items()}
    return eng.stats, reqs, wall, eng.hit_ratio(), info


def tick_rows(prof):
    """The device kernel rows of a torch.profiler run -> [(name, count,
    device us)]."""
    from torch.autograd import DeviceType
    return [(ev.key, ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def profile_tick_wave(card, cfg, model, prompts, dev):
    """Where the tick's time goes: one wave (``max_batch`` requests,
    SERVE_PROFILE_MAX_NEW new tokens) run twice on fresh engines, first
    unprofiled (host ms of the admit tick and per decode tick, each ending
    in its one sync), then under torch.profiler (device busy, kernels per
    tick, the costliest device ops).  The busy share is the profiled
    device time over the unprofiled wall: the profiler's own host work
    stretches the profiled wall (printed beside it) -> that share."""
    from torch.profiler import ProfilerActivity, profile
    wave = prompts[:SERVE_ENGINE["max_batch"]]
    windows = []
    for profiled in (False, True):
        eng, _, _ = build_tick(cfg, model, dev)
        for p in wave:
            eng.submit(p, max_new=SERVE_PROFILE_MAX_NEW)
        for first in (True, False):
            steps0 = dict(eng.ticks)
            prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                    else contextlib.nullcontext())
            sync(dev)
            t0 = time.perf_counter()
            with prof:
                eng.step() if first else eng.run()
                sync(dev)
            win = dict(wall=(time.perf_counter() - t0) * 1e3,
                       ticks={k: eng.ticks[k] - steps0.get(k, 0)
                              for k in eng.ticks})
            if profiled:
                rows = tick_rows(prof)
                win.update(rows=sum(c for _, c, _ in rows),
                           busy=sum(t for _, _, t in rows) / 1e3,
                           top=[(t, k) for k, _, t in rows])
            windows.append(win)
        del eng
        gc.collect()
    plain_admit, plain_dec, admit, dec = windows
    n_dec = dec["ticks"].get("decode", 0)
    if plain_dec["ticks"] != dec["ticks"] or admit["ticks"] != {"admit": 1}:
        raise AssertionError(f"the two waves ran other ticks: "
                             f"{[w['ticks'] for w in windows]}")
    wall = plain_admit["wall"] + plain_dec["wall"]
    pwall = admit["wall"] + dec["wall"]
    busy = admit["busy"] + dec["busy"]
    top = ", ".join(f"{k[:40]} {t / 1e3:.1f} ms" for t, k in
                    sorted(admit["top"] + dec["top"], reverse=True)[:6])
    say(card, f"serving tick wave: one wave ({len(wave)} requests, "
              f"{SERVE_PROFILE_MAX_NEW} new tokens each; 1 admit tick, "
              f"{n_dec} decode ticks): unprofiled wall {wall:.2f} ms (admit "
              f"tick {plain_admit['wall']:.2f} ms, decode tick "
              f"{plain_dec['wall'] / max(n_dec, 1):.3f} ms; host clock, each "
              f"ending in its one sync); under torch.profiler device busy "
              f"{busy:.1f} ms (admit tick {admit['busy']:.1f}, decode tick "
              f"{dec['busy'] / max(n_dec, 1):.3f}) = {busy / wall:.1%} of the "
              f"unprofiled wall (of the profiled wall {pwall:.1f} ms, which "
              f"the profiler stretches: {busy / pwall:.1%}); device kernels: "
              f"admit tick {admit['rows']}, per decode tick "
              f"{dec['rows'] / max(n_dec, 1):.1f}; host launches per tick: "
              f"one graph; top device ops: {top}")
    return busy / wall, busy / pwall


def phase_serve_tick(card, dev, results, serve):
    """The device-resident serving tick (``EngineConfig(jitted=True)``) at
    full width through ``Engine.submit`` / ``Engine.run``: CUDA graphs
    captured once per kind, replays that never synchronise, stats, hit
    ratio and per-request token counts equal to ``phase_serve_path``'s host
    loop (tokens by the bf16-tie rule); again with decode_block=4 and with
    TinyLFU (kernel 1 in the admit graph), each against the host loop
    under the same config; kernel launches counted as each graph's launches
    at capture times its replays, and seen as device rows of profiled
    replays; tokens/s of the tick and the host loop in turns."""
    cfg = serve_config()
    model, prompts = serve["model"], serve["prompts"]
    torch.cuda.reset_peak_memory_stats()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def run_tick(label, host, rec, **kw):
        st, reqs, wall, hr, info = drive_tick(cfg, model, prompts, dev,
                                              profiled=True, **kw)
        free()
        hst, hreqs, hwall, hhr = host
        if st != hst or hr != hhr:
            raise AssertionError(f"{label}: tick stats {st}, hit ratio "
                                 f"{hr!r}; host loop {hst}, {hhr!r}")
        equal, gap = check_tick_tokens(rec, hreqs, reqs)
        n_tok = sum(len(t) for t, _ in reqs.values())
        # the Python launch counters move only at capture: the launches of
        # this checked run are each graph's launches at capture times its
        # replays, every tick a graph replay; every tick runs decode_block
        # decode steps' layers (a step with no lane active still launches
        # them: the graph is fixed; at decode_block=1 every tick of this
        # traffic decodes, so kernel 5 is 30 x decode_steps there)
        burst = kw.get("decode_block", 1) * sum(info["ticks"].values())
        lanes = SERVE_ENGINE["max_batch"] * info["ticks"].get("admit", 0)
        want = {"paged_attention": cfg.num_layers * burst,
                "kway_fused_probe": lanes,
                "kway_probe": lanes if kw.get("tinylfu") else 0}
        launches, rows = info["launches"], info["rows"]
        if launches != want or (not kw and burst != st["decode_steps"]):
            raise AssertionError(f"{label}: launches {launches}, want {want}"
                                 f" (kernel 5: {cfg.num_layers} x "
                                 f"decode_block x ticks, {burst}, with "
                                 f"{st['decode_steps']} decode steps; "
                                 f"kernels 2, 1: one per lane of each admit "
                                 f"tick)")
        # the device rows of the profiled replays show that the kernels ran
        # on the card; CUPTI may drop records of a long trace (1906 of 1920
        # kernel-5 rows in one H100 run), so a row count is checked against
        # the launches as a bound, never as the count itself
        if any(rows[k] > launches[k] or (rows[k] == 0) != (launches[k] == 0)
               for k in want):
            raise AssertionError(f"{label}: device rows {rows} of launches "
                                 f"{launches}: a kernel ran no time, or "
                                 f"more often than its graphs launch it")
        say(card, f"{label}: tick == host loop in stats {st}, hit ratio "
                  f"{hr!r}, per-request token counts and prefix hits; "
                  f"{equal} of {len(reqs)} requests' tokens equal, the rest "
                  f"diverge at a bf16 tie (largest logit gap {gap:.4g}); "
                  f"ticks {info['ticks']} (every tick a replay), warm-up + "
                  f"capture {info['build_s']:.2f} s; launches (each "
                  f"graph's at capture x its replays) {launches}, device "
                  f"rows of this run's replays under torch.profiler {rows}; "
                  f"{n_tok} tokens in "
                  f"{wall:.3f} s under torch.profiler (host loop "
                  f"{n_tok / hwall:.1f} tokens/s; unprofiled times below)")
        return info

    counts, rows = Counter(), Counter()
    for label, kw in (("serving tick (decode_block=1)", {}),
                      ("serving tick (decode_block=4)",
                       dict(decode_block=4)),
                      ("serving tick (tinylfu)", dict(tinylfu=True))):
        if kw:
            with SampleRecorder() as rec:
                host = drive_engine(cfg, model, "cuda", prompts, dev,
                                    recorder=rec, **kw)
        else:
            host, rec = serve["host"], serve.pop("host_rec")
        info = run_tick(label, host, rec, **kw)
        del rec
        free()
        if not kw:
            build_s = info["build_s"]
        counts.update(info["launches"])
        rows.update(info["rows"])
    for name, c in counts.items():
        if c <= 0 or rows[name] <= 0:
            raise AssertionError(f"kernel {name} ran no time in the tick's "
                                 f"replays: launches {dict(counts)}, device "
                                 f"rows {dict(rows)}")
        results[name]["launches"] = results[name].get("launches", 0) + c
    say(card, f"main path (serving tick, the three checked runs) launches, "
              f"each graph's at capture x its replays: {dict(counts)}; "
              f"device rows of those replays under torch.profiler: "
              f"{dict(rows)}")

    busy, busy_profiled = profile_tick_wave(card, cfg, model, prompts, dev)
    free()

    runs = {"host": [], "tick": []}
    for r in range(SERVE_TICK_ROUNDS):
        for side in ("host", "tick", "tick", "host"):
            if side == "host":
                st, reqs, wall, _ = drive_engine(cfg, model, "cuda",
                                                 prompts, dev)
                n_tok = sum(len(t) for t, _, _ in reqs.values())
            else:
                st, reqs, wall, _, _ = drive_tick(cfg, model, prompts, dev)
                n_tok = sum(len(t) for t, _ in reqs.values())
            free()
            runs[side].append(n_tok / wall)
            say(card, f"serving timing round {r + 1}, {side}: {n_tok} "
                      f"tokens in {wall:.4f} s = {n_tok / wall:.2f} tokens/s")
    med = {k: statistics.median(v) for k, v in runs.items()}
    say(card, f"serving tokens/s, {SERVE_TICK_ROUNDS} rounds of host / tick "
              f"/ tick / host: tick {runs['tick']} (median {med['tick']:.2f})"
              f", host loop {runs['host']} (median {med['host']:.2f}); "
              f"tick slowest {min(runs['tick']):.2f} vs host fastest "
              f"{max(runs['host']):.2f}")
    peak = torch.cuda.max_memory_allocated()
    say(card, f"serving tick: peak device memory {peak} B "
              f"(torch.cuda.max_memory_allocated, weights, the host loop's "
              f"and the tick's pools and the graphs' pool)")
    results["paged_attention"].update(
        serve_tick_tokens_per_s=med["tick"],
        serve_tick_host_tokens_per_s=med["host"],
        serve_tick_runs=runs, serve_tick_busy_share=busy,
        serve_tick_busy_share_of_profiled_wall=busy_profiled,
        serve_tick_capture_s=build_s, serve_tick_peak_bytes=peak)
    free()


def _pa_pairs(args, softcap_kw):
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import ref as kref
    got = kpa.paged_attention(*args, **softcap_kw)
    want = kref.paged_attention_ref(*args, **softcap_kw)
    if not torch.isfinite(got).all():
        raise AssertionError("kernel 5 gave non-finite values")
    tol = PA_TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(),
                                   **PA_BF16_ROUNDING)
    return float((got.float() - want.float()).abs().max())


def phase_paged_attention_kernel(card, dev, results, serve):
    """Kernel 5 against its plain version on the card: every layer of the
    captured full-width decode step in bf16 (3e-2, and within two bf16
    ulps) and as float32 copies (2e-5, TF32 off), and a GQA + softcap case
    on random pools."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 must be off for the float32 comparison")
    err_bf = err_f32 = 0.0
    for q, kp, vp, pt, sl, kw in serve["inputs"]:
        err_bf = max(err_bf, _pa_pairs((q, kp, vp, pt, sl), kw))
        err_f32 = max(err_f32, _pa_pairs(
            (q.float(), kp.float(), vp.float(), pt, sl), kw))
    q, kp, _, pt, sl, _ = serve["inputs"][0]
    say(card, f"kernel 5 == plain on the captured decode step "
              f"{SERVE_CAPTURE_STEP} ({len(serve['inputs'])} layers, q {tuple(q.shape)}, pools "
              f"{tuple(kp.shape)}, page table {tuple(pt.shape)}, seq_lens "
              f"{sl.tolist()}): bf16 max abs err {err_bf:.3g} (tol 3e-2, and "
              f"atol 1e-3 + rtol 8e-3), "
              f"float32 {err_f32:.3g} (tol 2e-5)")
    c = GQA_CASE
    rng = np.random.default_rng(2)
    h = c["kvh"] * c["g"]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    qg = rand(c["b"], h, c["d"])
    kg = rand(c["kvh"], c["pages"], c["page"], c["d"])
    vg = rand(c["kvh"], c["pages"], c["page"], c["d"])
    ptg = torch.from_numpy(rng.integers(0, c["pages"], (c["b"], c["pps"]))
                           .astype(np.int32)).to(dev)
    slg = torch.from_numpy(rng.integers(1, c["pps"] * c["page"] + 1, c["b"])
                           .astype(np.int32)).to(dev)
    kw = dict(softcap=c["softcap"])
    gqa_f32 = _pa_pairs((qg, kg, vg, ptg, slg), kw)
    gqa_bf = _pa_pairs(tuple(t.bfloat16() for t in (qg, kg, vg))
                       + (ptg, slg), kw)
    say(card, f"kernel 5 == plain, GQA G={c['g']} D={c['d']} softcap "
              f"{c['softcap']} (gemma2-2b's heads), B={c['b']}, random pools:"
              f" float32 max abs err {gqa_f32:.3g} (tol 2e-5), bf16 "
              f"{gqa_bf:.3g} (tol 3e-2, and atol 1e-3 + rtol 8e-3)")
    results["paged_attention"].update(
        max_abs_err=err_bf, tol=3e-2, max_abs_err_f32=err_f32,
        gqa_max_abs_err_f32=gqa_f32, gqa_max_abs_err=gqa_bf)


def pa_bound(q, k_pages, page_table, seq_lens):
    """(bound ms, bound_by, bytes) of one kernel-5 call: each valid K/V row
    read once, q read and the output written once, the page-table entries
    of the pages in use and the lengths read; operations 4 x H x D per
    (sequence, position), at the bf16 tensor-core rate."""
    b, h, d = q.shape
    kvh, _, page, _ = k_pages.shape
    lens = seq_lens.long().clamp(max=page_table.shape[1] * page)
    el = q.element_size()
    n_pages = int(((lens + page - 1) // page).sum())
    nbytes = (2 * kvh * d * el * int(lens.sum()) + 2 * b * h * d * el
              + 4 * n_pages + 4 * b)
    ops = 4 * h * d * int(lens.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def round_robin(fns):
    """A call that runs the next of ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls issued back
    to back without a sync: what the caller's thread pays (the device runs
    behind it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def graph_device_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events around
    replays of one CUDA graph that holds ``reps`` calls: no host launch
    time, only the graph's own gaps between kernels, so never below the
    kernels' device time.  (torch.profiler's rows can come back short on a
    long run, which put a device time under its bytes bound.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (rounds * reps)
    del graph
    return ms


def time_paged_attention(runs):
    """Kernel 5's wrapper calls ``runs`` (one per layer) in turn, as a
    decode step runs them: (ms per call by CUDA events over 10 rounds, host
    ms per call over 10 rounds, device ms by CUDA events over replays of a
    graph of 3 rounds)."""
    n = len(runs)
    return (cuda_ms(round_robin(runs), 10 * n),
            host_ms(round_robin(runs), 10 * n),
            graph_device_ms(round_robin(runs), 3 * n))


def phase_paged_attention_timing(card, dev, results, serve):
    """Kernel 5 timed round-robin over every captured layer of the decode
    step, as a step runs them, so that no call finds its K/V in the 50 MB
    L2 cache from the call before (one layer's K/V is 63.8 MB): CUDA events
    around wrapper calls, the wrapper's host time per call, the kernel's
    device time by CUDA events over replays of a CUDA graph of the
    calls, the plain version, and
    scaled_dot_product_attention on each layer's K/V gathered beforehand
    into a contiguous [B, H, T, D] (a yardstick: it excludes the gather,
    and the port never calls it).  Then layer 0 alone, 200 times, as the
    previous design was timed, so that its figures stay comparable."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import ref as kref

    inputs = serve["inputs"]
    n = len(inputs)
    runs = [lambda a=a: kpa.paged_attention(*a[:5], **a[5]) for a in inputs]
    plains = [lambda a=a: kref.paged_attention_ref(*a[:5], **a[5])
              for a in inputs]
    q, kp, _, pt, sl, _ = inputs[0]
    bound, by, nbytes = pa_bound(q, kp, pt, sl)
    b, h, d = q.shape
    kvh, _, page, _ = kp.shape
    lens = sl.long()
    t = int((lens.max() + page - 1) // page) * page
    tab = pt[:, :t // page].long()
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]

    def gather(pool):
        g = pool[:, tab].reshape(kvh, b, t, d).transpose(0, 1)
        return g.repeat_interleave(h // kvh, dim=1).contiguous()

    sdpas = []
    for qi, kpi, vpi, pti, sli, _ in inputs:
        if not (torch.equal(pti, pt) and torch.equal(sli, sl)):
            raise AssertionError("the layers of one decode step share their "
                                 "page table and lengths")
        kc, vc, qs = gather(kpi), gather(vpi), qi[:, :, None, :]
        sdpas.append(lambda qs=qs, kc=kc, vc=vc:
                     F.scaled_dot_product_attention(qs, kc, vc,
                                                    attn_mask=mask))
    lib_err = float((sdpas[0]()[:, :, 0].float()
                     - runs[0]().float()).abs().max())

    ms, host, dev_ms = time_paged_attention(runs)
    lib = cuda_ms(round_robin(sdpas), 10 * n)
    plain = cuda_ms(round_robin(plains), n)
    ms0 = cuda_ms(runs[0], 200)
    dev0 = graph_device_ms(runs[0], 50)
    lib0 = cuda_ms(sdpas[0], 200)
    del sdpas
    torch.cuda.empty_cache()
    r = results["paged_attention"]
    r.update(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain,
             bound_ms=bound, bound_by=by, library_ms=lib,
             bound_share=bound / dev_ms,
             layer0_ms=ms0, layer0_device_ms=dev0, layer0_library_ms=lib0,
             split=list(kpa.split_plan(
                 page, d, q.element_size(), pt.shape[1], b, kvh,
                 torch.cuda.get_device_properties(
                     dev).multi_processor_count)))
    say(card, f"paged_attention round-robin over the {n} layers of decode "
              f"step {SERVE_CAPTURE_STEP} (B={b} H={h} KVH={kvh} D={d} "
              f"page={page}, {int(lens.sum())} tokens; W, pages per CTA, S ="
              f" {r['split']}): {ms:.4f} ms per wrapper call (CUDA events, "
              f"{10 * n} calls), host {host:.4f} ms per call "
              f"(perf_counter, no sync), kernel device time "
              f"{fmt_ms(dev_ms)} (CUDA events over replays of a CUDA graph "
              f"of {3 * n} calls), bound "
              f"{bound:.6f} ms by {by} ({nbytes} B; bound share "
              f"{fmt_share(r['bound_share'])}), plain {plain:.4f} ms; "
              f"library_ms {lib:.4f} (scaled_dot_product_attention on K/V "
              f"gathered beforehand into [B, H, {t}, D], gather excluded; "
              f"max abs diff to the kernel {lib_err:.3g})")
    say(card, f"paged_attention layer 0 alone (the previous design's method):"
              f" {ms0:.4f} ms per wrapper call (CUDA events, 200 calls), "
              f"device time {fmt_ms(dev0)} (CUDA events over replays of a "
              f"CUDA graph of 50 calls), "
              f"library_ms {lib0:.4f}")
    say_previous(card, "paged_attention")
    if dev_ms < bound:
        raise AssertionError(f"paged_attention device time {dev_ms} ms is "
                             f"under its bytes bound {bound} ms: the "
                             f"measurement or the bound is wrong")
    host_launches = n * serve["stats"]["decode_steps"]
    say(card, f"serving (host loop): {r['serve_tokens_per_s']:.1f} tokens/s,"
              f" {serve['stats']['decode_steps']} decode steps x {n} layers "
              f"= {host_launches} kernel-5 launches; kernel 5 at {ms:.4f} ms "
              f"would be {ms * host_launches / 1e3:.3f} s of the "
              f"{r['serve_s']:.3f} s run")


# ---------------------------------------------------------------------------
# every model family: MoE serving at full width, the sampler, full-width
# forward / decode consistency
# ---------------------------------------------------------------------------

#: the families phase's serving model: mixtral-8x22b at its full width, its
#: depth cut from 56 to FAMILY_LAYERS layers (56 layers are 282 GB of bf16
#: weights, 3.5 cards), random bf16 weights made on the card from seed 0,
#: served on the serving cell's engine and traffic (SERVE_*)
FAMILY_ARCH, FAMILY_LAYERS = "mixtral-8x22b", 4
#: configs whose full-width forward is held to FAMILY_STEPS decode steps
#: at full depth (and mixtral at FAMILY_LAYERS), at the reference's 6e-2;
#: their bf16 drift is also measured on the host CPU, which sets the
#: card's limit (not mixtral's: its 20.8 GB would have to be copied to the
#: host and its dense expert products run there)
FAMILY_CONSISTENCY = ("mamba2-130m", "hymba-1.5b", "seamless-m4t-large-v2")
FAMILY_STEPS = 8
#: the card's bf16 drift may be this many times the host CPU's, and a bf16
#: decode this many times as far from its float32 run as the forward
DRIFT_FACTOR = 1.5
#: the sampled tick run (the reference's burst-sampled engine test's
#: sampler at the cell's engine)
FAMILY_SAMPLED = dict(temperature=0.8, sample_seed=3, decode_block=4)
#: decode ticks timed, by host clock, then as back-to-back graph replays
#: (after the admit tick's decode: 25 of the wave's 32 decode steps, so
#: every lane stays active)
FAMILY_TIMED_TICKS = 12
#: rounds of host loop / tick / tick / host loop tokens/s
FAMILY_ROUNDS = 1
#: decode-graph replays under torch.profiler (after the timed ones; the
#: lanes retire at the wave's 32nd decode step)
FAMILY_PROFILED_TICKS = 4
#: substrings of cuBLAS's and CUTLASS's matrix-product kernel names (the
#: H100's cuBLAS names its bf16 kernels ``nvjet_*``)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def family_config():
    """The families phase's serving config (a hook for CPU rehearsals)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(FAMILY_ARCH).config,
                               num_layers=FAMILY_LAYERS)


def family_consistency_configs():
    """(label, config) of the full-width consistency checks (a hook for
    CPU rehearsals)."""
    from repro_torch import configs
    return [(a, configs.get(a).config) for a in FAMILY_CONSISTENCY] + [
        (f"{FAMILY_ARCH} ({FAMILY_LAYERS} layers)", family_config())]


def decode_weight_bytes(model) -> int:
    """Bytes of the weights one paged decode step reads: every block's
    (all experts: the dispatch is dense) and the head (one embedding row
    per token aside)."""
    blocks = sum(p.numel() * p.element_size()
                 for p in model.blocks.parameters())
    head = model.head()
    return blocks + head.numel() * head.element_size()


def phase_family_agreement(card, dev):
    """A small MoE input on the card agrees with the CPU: mixtral's smoke
    config with ``moe_ff_shards=2`` (its full config's 16 virtual
    experts' layout), one padded prefill and one paged decode step."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import paged_model as pm

    cfg = dataclasses.replace(configs.get(FAMILY_ARCH).smoke,
                              moe_ff_shards=2)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(2)
    toks = np.zeros((3, 32), np.int32)
    lengths = np.array([29, 11, 32], np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(2, cfg.vocab_size - 1, n)
    shape = (cfg.num_layers, cfg.num_kv_heads, 18, 8, cfg.hd)
    pools = torch.from_numpy(rng.standard_normal((2,) + shape).astype(
        np.float32)).bfloat16()
    pt = torch.arange(18, dtype=torch.int32).reshape(3, 6)
    out = []
    for d in (cpu, dev):
        model = lm.init_params(cfg, seed=0, device=cpu).to(d)
        logits, _, _ = pm.prefill_padded(cfg, model,
                                         torch.from_numpy(toks).to(d),
                                         torch.from_numpy(lengths).to(d))
        pk, pv = (t.clone().to(d) for t in pools)
        dl, _, _ = pm.decode_paged(
            cfg, model, torch.tensor([5, 7, 9], dtype=torch.int32, device=d),
            torch.from_numpy(lengths).to(d), pk, pv, pt.to(d),
            torch.ones(3, dtype=torch.bool, device=d))
        out.append((logits.cpu(), dl.cpu()))
    err = 0.0
    for a, b in zip(*out):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite MoE logits on the card")
        torch.testing.assert_close(b, a, atol=3e-2, rtol=3e-2)
        err = max(err, float((a - b).abs().max()))
    say(card, f"small MoE input agrees: {cfg.name} (moe_ff_shards=2) prefill"
              f" and paged decode logits on the card vs CPU, max abs err "
              f"{err:.3g} (tol 3e-2)")


def consistency_run(cfg, model, toks, enc_embeds, dev, dtype):
    """``lm.forward`` over the tokens and one ``lm.decode_step`` per token
    from ``init_cache`` (caches in ``dtype``; an encoder-decoder's cross
    caches filled from its encoder), each MoE layer's routing recorded ->
    (forward logits, decode logits, both float32 [B, S, Vp]; the positions
    before the first MoE discontinuity, and what it was; forward seconds,
    seconds per decode step)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    b, s = toks.shape
    kw = {} if enc_embeds is None else {"enc_embeds": enc_embeds.to(dtype)}
    routes = {s: [], 1: []}
    real_moe = L.moe

    def moe(p, x, **mkw):
        idx, _, _, keep, _ = L.moe_route(p, x, **mkw)
        routes[x.shape[1]].append((idx.sort(-1).values.cpu(), keep.cpu()))
        return real_moe(p, x, **mkw)

    L.moe = moe
    try:
        sync(dev)
        t0 = time.perf_counter()
        full = lm.forward(cfg, model, toks, **kw).float()
        sync(dev)
        fwd_s = time.perf_counter() - t0
        cache = lm.init_cache(cfg, b, 2 * s, dtype=dtype, device=dev)
        if cfg.enc_layers:
            enc = lm._encode(cfg, model, kw["enc_embeds"])
            for li, block in enumerate(model.blocks):
                k, v = L.cross_kv(block.cross, enc,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.hd)
                cache["cross_k"][li, :, :s] = k
                cache["cross_v"][li, :, :s] = v
            cache["cross_len"].fill_(s)
        outs = []
        sync(dev)
        t0 = time.perf_counter()
        for i in range(s):
            logits, cache = lm.decode_step(
                cfg, model, toks[:, i],
                torch.full((b,), i, dtype=torch.int32, device=dev), cache)
            outs.append(logits.float())
        sync(dev)
        dec_s = (time.perf_counter() - t0) / s
    finally:
        L.moe = real_moe
    dec = torch.stack(outs, 1)
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    n, why = s, ""
    layers = len(routes[s])
    for li, (idx, keep) in enumerate(routes[s]):
        for i in range(s):
            didx = routes[1][i * layers + li][0][:, 0]
            if i < n and not bool(keep[:, i].all()):
                n, why = i, f"a pair dropped at position {i}, layer {li}"
            if i < n and not torch.equal(didx, idx[:, i]):
                n, why = i, f"other experts at position {i}, layer {li}"
    if n < min(s, cfg.top_k * cfg.moe_ff_shards) and why.startswith("a pair"):
        raise AssertionError(f"{cfg.name}: {why}: under the capacity floor")
    return full, dec, n, why, fwd_s, dec_s


def drift(full, dec) -> float:
    """The largest relative error, over positions, of decode logits
    against forward logits ([B, S, V] each, the same positions)."""
    if not full.shape[1]:
        return 0.0
    return float(((dec - full).norm(dim=-1) / full.norm(dim=-1)).max())


def family_consistency(card, label, cfg, model, dev, seed=0):
    """``lm.forward`` over FAMILY_STEPS tokens (an encoder-decoder also
    encodes FAMILY_STEPS stub frames into its cross caches) against
    FAMILY_STEPS ``lm.decode_step``s from ``init_cache``, in bf16 (the
    serving dtype) and on a float32 copy of the same weights.

    float32, where the two paths must agree but for summation order: every
    logit within the reference's 6e-2.  bf16, where the two paths round
    differently (products of 16 rows and of 2): greedy tokens equal, or
    tied within 6e-2 in the forward's logits; and the drift (relative
    error of the decode's logits against the forward's) is held two ways.
    (1) For the FAMILY_CONSISTENCY configs the same bf16 run on the host
    CPU (the same code, on the reference's numerics: its bf16 drift equals
    the reference's at smoke size, ``tests/test_torch_lm_families.py``)
    sets the limit: the card's drift within DRIFT_FACTOR x the CPU's.
    (2) Against the float32 run, the decode is no further from its float32
    counterpart than DRIFT_FACTOR x the forward is from its: a fault of
    the bf16 decode path alone would move the decode, not the forward.

    A MoE layer is discontinuous where the two paths may part: the
    forward drops (token, k) pairs past an expert's capacity, which the
    one-token decode never does, and a near tie of two gates may route a
    token to other experts.  Positions from the first token with a dropped
    pair, or with other experts in any layer, on are left out (the first
    ``top_k * ff_shards`` positions never drop).  Frees ``model`` (moved
    and turned float32 in place)."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    b, s = 2, FAMILY_STEPS
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size - 1, (b, s))).to(
        dev)
    enc = None
    if cfg.enc_layers:
        enc = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32) * 0.02).to(dev)
    params = sum(p.numel() for p in model.parameters())
    runs, lines = {}, []
    sides = [("card bf16", dev, torch.bfloat16)]
    if label in FAMILY_CONSISTENCY:
        sides.append(("host CPU bf16", cpu, torch.bfloat16))
    sides.append(("card float32", dev, torch.float32))
    for side, d, dtype in sides:
        model.to(device=d, dtype=dtype)
        full, dec, n, why, fwd_s, dec_s = consistency_run(
            cfg, model, toks.to(d), None if enc is None else enc.to(d), d,
            dtype)
        full, dec = full.cpu(), dec.cpu()
        runs[side] = (full, dec, n)
        f, dd = full[:, :n], dec[:, :n]
        top = f.argmax(-1, keepdim=True)
        gap = (f.gather(-1, top) - f.gather(-1, dd.argmax(-1, keepdim=True))
               ).abs()
        if bool((gap > 6e-2 + 6e-2 * f.gather(-1, top).abs()).any()):
            raise AssertionError(f"{label} ({side}): greedy tokens differ "
                                 f"past a tie: gaps {gap.flatten()}")
        if dtype == torch.float32:
            torch.testing.assert_close(dd, f, atol=6e-2, rtol=6e-2)
        diff = (f - dd).abs()
        past = float((diff > 6e-2 + 6e-2 * f.abs()).float().mean()) \
            if n else 0.0
        lines.append(
            f"{side}: forward over {s} tokens x {b} ({fwd_s * 1e3:.1f} ms), "
            f"{s} decode_steps ({dec_s * 1e3:.2f} ms each), positions "
            f"0-{n - 1}" + (f" ({why}: not compared on)" if why else "")
            + f", greedy {int((top[..., 0] == dd.argmax(-1)).sum())}/"
            f"{top.numel()} equal (the rest tied), max abs diff "
            f"{float(diff.max()) if n else 0.0:.4g}, {past:.3%} of logits "
            f"past 6e-2, drift {drift(f, dd):.4g}")
    full, dec, n = runs["card bf16"]
    on_card = drift(full[:, :n], dec[:, :n])
    held = []
    if "host CPU bf16" in runs:
        cf, cd, cn = runs["host CPU bf16"]
        host = drift(cf[:, :cn], cd[:, :cn])
        if on_card > DRIFT_FACTOR * host:
            raise AssertionError(f"{label}: bf16 drift {on_card:.4g} on the "
                                 f"card > {DRIFT_FACTOR} x the host CPU's "
                                 f"{host:.4g}")
        held.append(f"card drift {on_card:.4g} <= {DRIFT_FACTOR} x the host"
                    f" CPU's {host:.4g} (ratio "
                    f"{on_card / host if host else 0.0:.3g})")
    f32, d32, n32 = runs["card float32"]
    m = min(n, n32)
    to_fwd = drift(f32[:, :m], full[:, :m])
    to_dec = drift(d32[:, :m], dec[:, :m])
    if to_dec > DRIFT_FACTOR * to_fwd:
        raise AssertionError(f"{label}: bf16 decode {to_dec:.4g} from its "
                             f"float32 run, > {DRIFT_FACTOR} x the "
                             f"forward's {to_fwd:.4g}")
    held.append(f"bf16 vs float32 on positions 0-{m - 1}: decode "
                f"{to_dec:.4g} <= {DRIFT_FACTOR} x forward {to_fwd:.4g} "
                f"(ratio {to_dec / to_fwd if to_fwd else 0.0:.3g})")
    say(card, f"{label} at full width ({cfg.num_layers} layers, d "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, {params} "
              f"parameters), forward == decode: " + "; ".join(lines)
        + "; held: " + "; ".join(held))


def phase_families(card, dev, results, serve):
    """Every model family at full width on the card.  The deepseek-7b
    serving model of the phases above is freed first.  mixtral-8x22b at
    full width and FAMILY_LAYERS layers: a smoke MoE input held to the
    CPU; the 16 requests through ``Engine.run`` on the ``cuda`` backend,
    counted (kernel 5 FAMILY_LAYERS x decode_steps times, kernel 1 ran),
    the ``torch`` backend's run equal; the tick (CUDA graphs, one capture
    per kind) greedy and sampled, each held to the host loop under the
    same config; tokens/s of both modes in turns; the decode tick's ms
    and device ms beside its bytes bound; then each family's forward held
    to its decode at full width."""
    from repro_torch import configs
    from repro_torch.models import lm

    serve.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_family_agreement(card, dev)
    cfg = family_config()
    e = SERVE_ENGINE
    n_bytes = 2 * cfg.param_count()
    k = cfg.top_k * cfg.moe_ff_shards
    cap = max(int(e["max_prompt"] * k * 1.25 / cfg.num_virtual_experts), k)
    say(card, f"families config: {cfg.name} at full width, depth cut from "
              f"{configs.get(FAMILY_ARCH).config.num_layers} to "
              f"{cfg.num_layers} "
              f"layers, d {cfg.d_model}, {cfg.num_heads} heads x {cfg.hd} "
              f"({cfg.num_kv_heads} KV heads), {cfg.num_experts} experts "
              f"top-{cfg.top_k}, moe_ff_shards {cfg.moe_ff_shards} "
              f"({cfg.num_virtual_experts} virtual experts of d_ff "
              f"{cfg.virtual_d_ff}), vocab {cfg.vocab_size}: "
              f"{cfg.param_count()} parameters ({n_bytes} B bf16), random "
              f"from torch.Generator seed 0; engine and traffic of the "
              f"serving cell (SERVE_*); prefill capacity {cap} per virtual "
              f"expert per row, decode {k}")
    t0 = time.perf_counter()
    model = lm.init_params(cfg, seed=0, device=dev)
    sync(dev)
    say(card, f"families model made on the card in "
              f"{time.perf_counter() - t0:.1f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated()} B")
    prompts = serve_traffic(cfg.vocab_size)
    vp = lm.padded_vocab(cfg)

    # the host loop, counted, with the logits behind every token recorded
    reset_launch_counts()
    with SampleRecorder() as rec:
        st, reqs, wall, hr = drive_engine(cfg, model, "cuda", prompts, dev,
                                          recorder=rec)
    counts = launch_counts()
    if counts["paged_attention"] != cfg.num_layers * st["decode_steps"]:
        raise AssertionError(f"families: paged_attention launched "
                             f"{counts['paged_attention']} times, not "
                             f"{cfg.num_layers} x {st['decode_steps']}")
    check_launches(card, "families serving", ("kway_probe",
                                             "paged_attention"), results)
    for rid, (toks, _, _) in reqs.items():
        if len(toks) != SERVE_MAX_NEW + 1 or not all(0 <= t < vp
                                                    for t in toks):
            raise AssertionError(f"families request {rid}: tokens {toks}")
    if len(reqs) != SERVE_REQUESTS or st["prefills"] != SERVE_REQUESTS:
        raise AssertionError(f"families: served {len(reqs)}, stats {st}")
    n_tok = sum(len(t) for t, _, _ in reqs.values())
    say(card, f"families serving (host loop, cuda backend): {len(reqs)} "
              f"requests, {n_tok} tokens in {wall:.3f} s host wall "
              f"({n_tok / wall:.1f} tokens/s, logits recorded), hit ratio "
              f"{hr!r}, stats {st}")
    st2, reqs2, wall2, _ = drive_engine(cfg, model, "torch", prompts, dev)
    if (st2, reqs2) != (st, reqs):
        bad = [rid for rid in reqs if reqs[rid] != reqs2.get(rid)]
        raise AssertionError(f"families: torch backend run differs: stats "
                             f"{st2} vs {st}; requests {bad}")
    say(card, f"families: torch backend run == cuda backend run: stats, "
              f"pages, prefix hits and tokens of all {len(reqs)} requests "
              f"({wall2:.3f} s host wall)")
    gc.collect()
    torch.cuda.empty_cache()

    # the tick, greedy and sampled, each against the host loop
    runs = {"": (st, reqs, hr, rec)}
    tick_counts = Counter()
    for label, kw in (("greedy", {}), ("sampled", FAMILY_SAMPLED)):
        if kw:
            with SampleRecorder() as srec:
                hst, hreqs, _, hhr = drive_engine(
                    cfg, model, "cuda", prompts, dev, recorder=srec, **kw)
            runs[label] = (hst, hreqs, hhr, srec)
        else:
            runs[label] = runs[""]
        hst, hreqs, hhr, hrec = runs[label]
        tst, treqs, twall, thr, info = drive_tick(cfg, model, prompts, dev,
                                                  **kw)
        gc.collect()
        torch.cuda.empty_cache()
        if tst != hst or thr != hhr:
            raise AssertionError(f"families tick ({label}): stats {tst}, "
                                 f"hit ratio {thr!r}; host loop {hst}, "
                                 f"{hhr!r}")
        equal, gap = check_tick_tokens(hrec, hreqs, treqs)
        burst = kw.get("decode_block", 1) * sum(info["ticks"].values())
        lanes = e["max_batch"] * info["ticks"].get("admit", 0)
        want = {"paged_attention": cfg.num_layers * burst,
                "kway_fused_probe": lanes, "kway_probe": 0}
        if info["launches"] != want:
            raise AssertionError(f"families tick ({label}): launches "
                                 f"{info['launches']}, want {want}")
        tick_counts.update(info["launches"])
        say(card, f"families tick ({label}{', ' if kw else ''}"
                  f"{', '.join(f'{k}={v}' for k, v in kw.items())}): == host "
                  f"loop in stats {tst}, hit ratio {thr!r}, token counts and "
                  f"prefix hits; {equal} of {len(treqs)} requests' tokens "
                  f"equal, the rest diverge at a bf16 tie (largest gap "
                  f"{gap:.4g}); ticks {info['ticks']}, one capture per kind, "
                  f"warm-up + capture {info['build_s']:.2f} s, launches "
                  f"(each graph's at capture x its replays) "
                  f"{info['launches']}")
    for name, c in tick_counts.items():
        results[name]["launches"] = results[name].get("launches", 0) + c
    del runs, rec

    # tokens/s in turns, then the decode tick beside its bound
    tps = {"host": [], "tick": []}
    for r in range(FAMILY_ROUNDS):
        for side in ("host", "tick", "tick", "host"):
            if side == "host":
                _, rq, w, _ = drive_engine(cfg, model, "cuda", prompts, dev)
            else:
                _, rq, w, _, _ = drive_tick(cfg, model, prompts, dev)
            gc.collect()
            torch.cuda.empty_cache()
            n = sum(len(t[0]) for t in rq.values())
            tps[side].append(n / w)
            say(card, f"families timing round {r + 1}, {side}: {n} tokens in "
                      f"{w:.4f} s = {n / w:.2f} tokens/s")
    eng, _, _ = build_tick(cfg, model, dev)
    for p in prompts[:e["max_batch"]]:
        eng.submit(p, max_new=SERVE_MAX_NEW)
    eng.step()                                   # the admit tick
    host = []
    for _ in range(FAMILY_TIMED_TICKS):
        sync(dev)
        t0 = time.perf_counter()
        eng.step()
        host.append((time.perf_counter() - t0) * 1e3)
    if eng.ticks.get("decode", 0) != FAMILY_TIMED_TICKS:
        raise AssertionError(f"families: timed ticks {dict(eng.ticks)}")
    # the replays' mean K/V length: each replay adds one token a lane
    kv_tokens = int(eng._state.pos.sum()) + e["max_batch"] * (
        FAMILY_TIMED_TICKS + 1) // 2
    graph = eng._graphs["decode"]
    with torch.cuda.stream(eng._stream):
        device_ms = cuda_ms(graph.replay, FAMILY_TIMED_TICKS, warmup=False)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(eng._stream):
            for _ in range(FAMILY_PROFILED_TICKS):
                graph.replay()
        sync(dev)
    rows = tick_rows(prof)
    busy = sum(t for _, _, t in rows) / 1e3 / FAMILY_PROFILED_TICKS
    gemm = sum(t for k, _, t in rows if any(
        g in k.lower() for g in GEMM_NAMES)) / 1e3 / FAMILY_PROFILED_TICKS
    top = ", ".join(f"{k[:44]} x{c // FAMILY_PROFILED_TICKS} "
                    f"{t / 1e3 / FAMILY_PROFILED_TICKS:.3f} ms"
                    for k, c, t in sorted(rows, key=lambda r: -r[2])[:6])
    say(card, f"families decode tick under torch.profiler "
              f"({FAMILY_PROFILED_TICKS} replays): "
              f"{sum(c for _, c, _ in rows) / FAMILY_PROFILED_TICKS:.0f} "
              f"device kernels and {busy:.3f} ms device busy a tick, of it "
              f"{gemm:.3f} ms in GEMM kernels (names with "
              f"{' / '.join(GEMM_NAMES)}); top: {top}")
    kv_bytes = 2 * cfg.num_layers * kv_tokens * cfg.num_kv_heads * cfg.hd * 2
    w_bytes = decode_weight_bytes(model)
    bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    tick_ms = statistics.median(host)
    peak = torch.cuda.max_memory_allocated()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: statistics.median(v) for k, v in tps.items()}
    say(card, f"families serving tokens/s ({FAMILY_ROUNDS} round of host / "
              f"tick / tick / host): tick {tps['tick']}, host loop "
              f"{tps['host']}")
    say(card, f"families decode tick ({e['max_batch']} lanes, "
              f"{cfg.num_layers} layers): {tick_ms:.3f} ms host wall (median "
              f"of {FAMILY_TIMED_TICKS}, each ending in its one sync), "
              f"{device_ms:.3f} ms device (CUDA events over "
              f"{FAMILY_TIMED_TICKS} back-to-back replays of the decode "
              f"graph); bound {bound:.3f} ms = ({w_bytes} B of weights, all "
              f"{cfg.num_virtual_experts} virtual experts (dense dispatch) "
              f"and the head, + {kv_bytes} B of K/V over {kv_tokens} "
              f"tokens, the replays' mean) / 3.35 TB/s = "
              f"{bound / device_ms:.1%} of the device "
              f"time; peak device memory {peak} B")
    results["paged_attention"].update(
        families_host_tokens_per_s=med["host"],
        families_tick_tokens_per_s=med["tick"],
        families_decode_tick_ms=tick_ms, families_decode_device_ms=device_ms,
        families_decode_bound_ms=bound, families_decode_profiled_ms=busy,
        families_decode_gemm_ms=gemm, families_peak_bytes=peak)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # each family's forward against its decode at full width
    for label, fcfg in family_consistency_configs():
        fmodel = lm.init_params(fcfg, seed=0, device=dev)
        family_consistency(card, label, fcfg, fmodel, dev)
        del fmodel
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: the timed training cell: the reference launcher's defaults (batch 8 x
#: seq 128, lr 3e-3, cosine, warmup 5) at gemma2-2b's full width and depth
TRAIN_ARCH = "gemma2-2b"
TRAIN_STEPS = 10
#: steps whose times are kept (4-10: the first three warm the allocator
#: and the kernels' autotuning)
TRAIN_TIMED_FROM = 4
#: the full-width agreement model: gemma2-2b with its depth cut to this
TRAIN_AGREE_LAYERS = 2
TRAIN_AGREE_SHAPE = (2, 32)
#: (a)'s optimizer: small steps (warmup 100), so three steps stay close
TRAIN_AGREE_OPT = dict(lr=1e-3, total_steps=10)
TRAIN_AGREE_STEPS = 3
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 3e-2
#: the resume cell: mamba2-130m at full width and depth; the schedule is
#: const because the launcher sizes its schedule by --steps (a 6-step run
#: and a 10-step run share a cosine schedule only up to step 5)
TRAIN_RESUME_ARGS = ["--arch", "mamba2-130m", "--batch", "8", "--seq", "128",
                     "--schedule", "const"]
TRAIN_RESUME_CUT = 6
TRAIN_CKPT_DIR = os.path.join(HERE, ".chip_smoke_train_ckpt")
#: the card's dense bf16 peak (H100 SXM), for the FLOP bound
BF16_FLOPS_PER_S = 989e12
#: (e) gemma2-2b at full size at train_4k's sequence length, a per-device
#: batch one card holds: 1 warm-up step, then TRAIN_4K_TIMED timed ones
TRAIN_4K_SHAPE = ("train_4k_b1", 4096, 1, "train")
TRAIN_4K_TIMED = 3
#: (e) as the previous revision's two whole runs measured it on an NVIDIA
#: H100 80GB HBM3 at 700.00 W (PERF.md section 6): constants, printed
#: beside this run's figures
TRAIN_4K_PREV = dict(step_ms=(1067.9, 1076.1), peak_bytes=67879567360,
                     predicted_bytes=67639440396, predicted_over_peak=0.9965)


@contextlib.contextmanager
def count_remat():
    """The blocks that enter ``torch.utils.checkpoint`` (the remat path of
    ``lm.forward``) while the block runs, as a list that grows."""
    from repro_torch.models import lm

    entered = []
    real = lm.checkpoint

    def counted(fn, *args, **kw):
        entered.append(fn)
        return real(fn, *args, **kw)

    lm.checkpoint = counted
    try:
        yield entered
    finally:
        lm.checkpoint = real


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32 on the CPU (the norm of the
    difference where ``want`` is all zeros)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got - want))
    return num / den if den else num


def grad_errors(got: dict, want: dict) -> dict:
    """{parameter name: relative L2 of its gradient} of two {name: gradient
    or None}; a gradient on one side only raises."""
    out = {}
    for name, w in want.items():
        if (got[name] is None) != (w is None):
            raise AssertionError(f"{name}: a gradient on one device only")
        out[name] = 0.0 if w is None else rel_l2(got[name], w)
    return out


def grads(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()}


def check_train_agreement(label, losses, errs):
    """Losses per step within TRAIN_LOSS_TOL relative, every gradient leaf
    within TRAIN_GRAD_TOL relative L2; -> (worst loss error, worst leaf
    name, its error)."""
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    worst = max(errs, key=errs.get)
    if loss_err > TRAIN_LOSS_TOL or not all(
            np.isfinite([a for a, _ in losses])):
        raise AssertionError(f"train {label}: losses card / CPU {losses}, "
                             f"relative error {loss_err:.3g} over "
                             f"{TRAIN_LOSS_TOL}")
    if errs[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"train {label}: gradient {worst} relative L2 "
                             f"{errs[worst]:.3g} over {TRAIN_GRAD_TOL}")
    return loss_err, worst, errs[worst]


def train_agreement_family(card, arch, dev):
    """(a) three ``make_train_step`` steps of ``arch``'s smoke config on
    the card and on the host CPU from the same weights and batches."""
    import copy
    from repro_torch import configs
    from repro_torch.data.pipeline import (DataConfig, DataState,
                                           SyntheticPipeline)
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    cpu = torch.device("cpu")
    cfg = configs.get(arch).smoke
    b, s = TRAIN_AGREE_SHAPE
    args = train.parse(["--arch", arch, "--smoke", "--batch", str(b),
                        "--seq", str(s)])
    tcfg = tstep.TrainConfig(optimizer=adamw.AdamWConfig(**TRAIN_AGREE_OPT))
    host = lm.init_params(cfg, seed=0, device=cpu)
    card_model = copy.deepcopy(host).to(dev)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=s, global_batch=b))
    runs = []
    for model, d in ((card_model, dev), (host, cpu)):
        step_fn = tstep.make_train_step(cfg, tcfg)
        state, ds, losses = adamw.init(model), DataState(), []
        for i in range(TRAIN_AGREE_STEPS):
            batch = train.make_batch(cfg, args, *pipe.batch(ds), d)
            ds = pipe.advance(ds)
            model, state, m = step_fn(model, state, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                step1 = {n: None if g is None else g.clone()
                         for n, g in grads(model).items()}
        runs.append((losses, step1))
    (card_losses, card_g), (host_losses, host_g) = runs
    return check_train_agreement(
        f"{arch} smoke", list(zip(card_losses, host_losses)),
        grad_errors(card_g, host_g))


def train_agreement_full_width(card, dev):
    """(b) gemma2-2b at full width, TRAIN_AGREE_LAYERS layers: the loss and
    every gradient of one [2, 32] batch on the card and on the host CPU."""
    import copy
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, DataState, \
        SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH).config,
                              num_layers=TRAIN_AGREE_LAYERS)
    b, s = TRAIN_AGREE_SHAPE
    args = train.parse(["--arch", TRAIN_ARCH, "--batch", str(b), "--seq",
                        str(s)])
    host = lm.init_params(cfg, seed=0, device=cpu)
    card_model = copy.deepcopy(host).to(dev)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=s, global_batch=b))
    toks, labels = pipe.batch(DataState())
    plain = copy.deepcopy(host).to(dev)        # the card, without remat
    losses, secs = [], []
    with count_remat() as entered:
        for model, d, remat in ((card_model, dev, True), (host, cpu, True),
                                (plain, dev, False)):
            loss_fn = tstep.make_loss_fn(cfg, tstep.TrainConfig(remat=remat))
            t0 = time.perf_counter()
            model.requires_grad_(True)
            loss = loss_fn(model, train.make_batch(cfg, args, toks, labels,
                                                   d))
            loss.backward()
            losses.append(float(loss.detach()))
            secs.append(time.perf_counter() - t0)
    if len(entered) != 2 * cfg.num_layers:
        raise AssertionError(f"train (b): {len(entered)} blocks "
                             f"rematerialised, not 2 x {cfg.num_layers}")
    loss_err, worst, err = check_train_agreement(
        f"{TRAIN_ARCH} full width, {cfg.num_layers} layers",
        [tuple(losses[:2])], grad_errors(grads(card_model), grads(host)))
    r_loss, r_worst, r_err = check_train_agreement(
        f"{TRAIN_ARCH} full width, {cfg.num_layers} layers, remat vs not "
        f"on the card", [(losses[0], losses[2])],
        grad_errors(grads(card_model), grads(plain)))
    r_abs = max(float((a.grad.float() - b.grad.float()).abs().max())
                for a, b in zip(card_model.parameters(), plain.parameters())
                if a.grad is not None)
    say(card, f"train (b) {TRAIN_ARCH} at full width, {cfg.num_layers} of "
              f"{configs.get(TRAIN_ARCH).config.num_layers} layers "
              f"({sum(p.numel() for p in host.parameters())} parameters), "
              f"one [{b}, {s}] batch: loss card {losses[0]:.6f} / host CPU "
              f"{losses[1]:.6f} (relative error {loss_err:.3g}, tol "
              f"{TRAIN_LOSS_TOL}); worst gradient leaf {worst} at relative "
              f"L2 {err:.3g} (tol {TRAIN_GRAD_TOL}); forward + backward "
              f"{secs[0]:.2f} s on the card (first call), {secs[1]:.2f} s "
              f"on the host CPU")
    say(card, f"train (b) on the card, remat against without: loss "
              f"{losses[0]!r} / {losses[2]!r} (equal: "
              f"{losses[0] == losses[2]}, relative {r_loss:.3g}); worst "
              f"gradient leaf {r_worst} at relative L2 {r_err:.3g} (tol "
              f"{TRAIN_GRAD_TOL}); largest absolute gradient difference "
              f"{r_abs!r}; without remat {secs[2]:.2f} s")
    return {"remat_loss_err": r_loss, "remat_grad_err": r_err,
            "remat_grad_max_abs": r_abs}


def timed_step_factory(marks: list):
    """A stand-in for the launcher's ``make_train_step`` that makes the
    same two calls (``make_value_and_grad``'s, then ``adamw.update``) with
    CUDA events around each, and the host clock at each step's start."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    def factory(cfg, tcfg):
        value_and_grad = tstep.make_value_and_grad(cfg, tcfg)

        def step(model, opt_state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t = time.perf_counter()
            ev[0].record()
            loss, grads = value_and_grad(model, batch)
            ev[1].record()
            model, opt_state, om = adamw.update(tcfg.optimizer, grads,
                                                opt_state, model)
            ev[2].record()
            marks.append((t, ev))
            return model, opt_state, {"loss": loss, **om}

        return step

    return factory


def optimizer_bytes(model) -> int:
    """Bytes one AdamW update must move: each gradient read twice (the
    global norm, then the leaf), the float32 master, m and v read and
    written, the parameter written."""
    return sum(p.numel() * (3 * p.element_size() + 24)
               for p in model.parameters())


def train_profile(card, cfg, args, run, med, out, label="(c)"):
    """Where a step's time goes: one more step after the timed run (the
    pipeline's next batch), its forward + backward and its optimizer each
    under torch.profiler (device activity only): device busy time, device
    kernels, the GEMMs' share, busy over the timed run's median (the
    device's busy share), top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import (DataConfig, DataState,
                                           SyntheticPipeline)
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    dev = run.model.device
    tcfg = tstep.TrainConfig(optimizer=train.optimizer_config(args))
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq,
                                        global_batch=args.batch))
    batch = train.make_batch(cfg, args, *pipe.batch(DataState(
        run.data_step)), dev)
    value_and_grad = tstep.make_value_and_grad(cfg, tcfg)
    grads = {}
    parts = (("fwd_bwd", "fb", lambda: grads.update(
                 value_and_grad(run.model, batch)[1])),
             ("optimizer", "opt", lambda: adamw.update(
                 tcfg.optimizer, grads, run.opt_state, run.model)))
    for name, key, fn in parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        kernels = sum(ev.count for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False))
        busy = sum(t for t, _ in rows) / 1e3
        if not busy:
            raise AssertionError(f"train {label} profile: no device rows "
                                 f"for {name}")
        gemm = sum(t for t, k in rows if any(
            g in k.lower() for g in GEMM_NAMES)) / 1e3
        top = ", ".join(f"{k[:40]} {t / 1e3:.2f} ms" for t, k in
                        sorted(rows, reverse=True)[:6])
        out[f"{name}_profile"] = dict(
            busy_ms=busy, gemm_ms=gemm, kernels=kernels,
            busy_share=busy / med[key], profiled_wall_ms=wall)
        say(card, f"train {label} profile, {name} of one step: device busy "
                  f"{busy:.3f} ms over {kernels} kernels = "
                  f"{busy / med[key]:.1%} of the unprofiled "
                  f"{med[key]:.3f} ms (profiled wall {wall:.1f} ms); GEMMs "
                  f"({' / '.join(GEMM_NAMES)}) {gemm:.3f} ms; top: {top}")


def train_timed_cell(card, dev, out):
    """(c) ``launch/train.run`` at gemma2-2b's full width and depth, the
    launcher's own defaults, TRAIN_STEPS steps, the step timed by CUDA
    events (forward + backward, then the optimizer)."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = configs.get(TRAIN_ARCH).config
    args = train.parse(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS)])
    ocfg = train.optimizer_config(args)
    tokens = args.batch * args.seq
    say(card, f"train (c) config: {cfg.name} at full width and depth "
              f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} "
              f"heads x {cfg.hd}, {cfg.num_kv_heads} KV heads, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied), random from seed "
              f"{args.seed}; SyntheticPipeline batch {args.batch} x seq "
              f"{args.seq} ({tokens} tokens a step); AdamW lr {ocfg.lr} "
              f"{ocfg.schedule}, warmup {ocfg.warmup_steps}, total "
              f"{ocfg.total_steps}; {TRAIN_STEPS} steps through "
              f"launch.train.run")
    marks = []
    real = train.make_train_step
    train.make_train_step = timed_step_factory(marks)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with count_remat() as entered:
            run = train.run(args)
    finally:
        train.make_train_step = real
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    if len(entered) != TRAIN_STEPS * cfg.num_layers:
        raise AssertionError(f"train (c): {len(entered)} blocks "
                             f"rematerialised in {TRAIN_STEPS} steps")
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train (c): losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (c): loss at step {TRAIN_STEPS} "
                             f"{losses[-1]} not below step 1's {losses[0]}")
    n_params = sum(p.numel() for p in run.model.parameters())
    opt_bytes = optimizer_bytes(run.model)
    fresh = lm.init_params(cfg, seed=args.seed, device=dev)
    unchanged = [n for (n, a), (_, b) in zip(run.model.named_parameters(),
                                             fresh.named_parameters())
                 if a.dtype == torch.bfloat16 and torch.equal(a, b)]
    changed_share = float(np.mean([
        float((a != b).float().mean()) for (_, a), (_, b) in zip(
            run.model.named_parameters(), fresh.named_parameters())
        if a.dtype == torch.bfloat16]))
    del fresh
    if unchanged:
        raise AssertionError(f"train (c): bf16 parameters unchanged after "
                             f"{TRAIN_STEPS} steps: {unchanged}")
    fb = [s.elapsed_time(e) for _, (s, e, _) in marks]
    opt = [s.elapsed_time(e) for _, (_, s, e) in marks]
    step = [a + b for a, b in zip(fb, opt)]
    starts = [t for t, _ in marks]
    wall_steps = [b - a for a, b in zip(starts, starts[1:])]
    k = TRAIN_TIMED_FROM - 1
    med = {name: statistics.median(v[k:]) for name, v in
           (("step", step), ("fb", fb), ("opt", opt))}
    med["wall"] = statistics.median(wall_steps[k:]) * 1e3
    train_profile(card, cfg, args, run, med, out)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    flop_ms = 6 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    bound = flop_ms + bytes_ms
    out.update(
        arch=cfg.name, layers=cfg.num_layers, params=n_params,
        batch=args.batch, seq=args.seq, steps=TRAIN_STEPS,
        losses=losses, step_ms=med["step"], fwd_bwd_ms=med["fb"],
        optimizer_ms=med["opt"], wall_step_ms=med["wall"],
        tokens_per_s=tokens / med["step"] * 1e3,
        wall_tokens_per_s=tokens / med["wall"] * 1e3,
        peak_bytes=peak, flop_bound_ms=flop_ms, bytes_bound_ms=bytes_ms,
        step_bound_ms=bound, flop_share=flop_ms / med["fb"],
        bytes_share=bytes_ms / med["opt"], step_share=bound / med["step"],
        optimizer_bytes=opt_bytes, changed_share=changed_share,
        step_ms_all=step, launches=counts, run_s=wall,
        remat_blocks=len(entered))
    say(card, f"train (c) {cfg.name}: {n_params} parameters; losses "
              f"{' '.join(f'{x:.4f}' for x in losses)} (finite; step "
              f"{TRAIN_STEPS} below step 1); every bf16 leaf changed "
              f"({changed_share:.1%} of bf16 elements); {len(entered)} "
              f"blocks rematerialised ({cfg.num_layers} a step)")
    say(card, f"train (c) {cfg.name}: step {med['step']:.3f} ms (CUDA events, "
              f"median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}) = forward "
              f"+ backward {med['fb']:.3f} ms + optimizer {med['opt']:.3f} "
              f"ms; host wall {med['wall']:.3f} ms a step (the launcher "
              f"syncs on each loss); {out['tokens_per_s']:.1f} tokens/s "
              f"(device), {out['wall_tokens_per_s']:.1f} (wall); peak "
              f"device memory {peak} B; every step's ms "
              f"{' '.join(f'{x:.2f}' for x in step)}")
    say(card, f"train (c) bounds: FLOPs 6 x {n_params} x {tokens} = "
              f"{6 * n_params * tokens:.4g} at {BF16_FLOPS_PER_S:.4g} "
              f"FLOP/s = {flop_ms:.3f} ms ({out['flop_share']:.1%} of "
              f"forward + backward); optimizer bytes {opt_bytes} at "
              f"{HBM_BYTES_PER_S:.4g} B/s = {bytes_ms:.3f} ms "
              f"({out['bytes_share']:.1%} of the optimizer); step bound "
              f"{bound:.3f} ms ({out['step_share']:.1%} of the step); "
              f"kernel launches of the port in the run: {counts} (training "
              f"runs none of the cache kernels)")


def train_resume_cell(card, out):
    """(d) ``launch/train.run`` on mamba2-130m at full width and depth: 6
    steps with a checkpoint every 3, then a resume to 10, against an
    uninterrupted 10-step run from the same start."""
    import shutil
    from repro_torch.ckpt import manager as ckpt
    from repro_torch.launch import train

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    common = TRAIN_RESUME_ARGS + ["--ckpt-every", "3"]
    try:
        t0 = time.perf_counter()
        first = train.run(train.parse(common + [
            "--steps", str(TRAIN_RESUME_CUT), "--ckpt-dir", TRAIN_CKPT_DIR]))
        t1 = time.perf_counter()
        if ckpt.latest_step(TRAIN_CKPT_DIR) != TRAIN_RESUME_CUT:
            raise AssertionError("train (d): no checkpoint at step "
                                 f"{TRAIN_RESUME_CUT}")
        ck_bytes = sum(
            os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(
                os.path.join(TRAIN_CKPT_DIR, f"step_{TRAIN_RESUME_CUT:09d}"))
            for f in fs)
        del first.model, first.opt_state
        rest = train.run(train.parse(common + [
            "--steps", str(TRAIN_STEPS), "--ckpt-dir", TRAIN_CKPT_DIR]))
        t2 = time.perf_counter()
        del rest.model, rest.opt_state
        if ckpt.latest_step(TRAIN_CKPT_DIR) != TRAIN_STEPS:
            raise AssertionError("train (d): the resumed run did not save "
                                 f"step {TRAIN_STEPS}")
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    whole = train.run(train.parse(TRAIN_RESUME_ARGS + [
        "--steps", str(TRAIN_STEPS)]))
    t3 = time.perf_counter()
    del whole.model, whole.opt_state
    gc.collect()
    torch.cuda.empty_cache()
    cursors = (first.data_step, rest.start_step, rest.data_step,
               whole.data_step)
    if cursors != (TRAIN_RESUME_CUT, TRAIN_RESUME_CUT, TRAIN_STEPS,
                   TRAIN_STEPS):
        raise AssertionError(f"train (d): data cursors / resume step "
                             f"{cursors}")
    pairs = list(zip(first.losses + rest.losses, whole.losses))
    if len(pairs) != TRAIN_STEPS:
        raise AssertionError(f"train (d): {len(pairs)} losses")
    err = max(abs(a - b) / abs(b) for a, b in pairs)
    if err > TRAIN_LOSS_TOL or not np.all(np.isfinite(whole.losses)):
        raise AssertionError(f"train (d): resumed losses {pairs}, relative "
                             f"error {err:.3g} over {TRAIN_LOSS_TOL}")
    out.update(resume_loss_err=err, resume_ckpt_bytes=ck_bytes,
               resume_first_s=t1 - t0, resume_rest_s=t2 - t1,
               resume_whole_s=t3 - t2)
    say(card, f"train (d) mamba2-130m at full width and depth, "
              f"{' '.join(TRAIN_RESUME_ARGS[2:])}: {TRAIN_RESUME_CUT} steps "
              f"(checkpoints every 3, {ck_bytes} B each) in {t1 - t0:.1f} s, "
              f"resumed at step {rest.start_step} (data cursor "
              f"{first.data_step}) to {TRAIN_STEPS} in {t2 - t1:.1f} s; "
              f"uninterrupted {TRAIN_STEPS} steps in {t3 - t2:.1f} s; every "
              f"loss within {err:.3g} relative (tol {TRAIN_LOSS_TOL}: the "
              f"card's gradient sums need not repeat their order); losses "
              f"{' '.join(f'{a:.5f}/{b:.5f}' for a, b in pairs)}")


def train_4k_predict(cfg, shape) -> dict:
    """(e)'s prediction: ``dryrun.run_cell`` of the cell on a one-device
    "cuda" mesh under FakeTensorMode (one microbatch), with remat and
    without -> {remat: (predicted bytes, record, seconds)}.  The one-rank
    NCCL group is destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_dev_mesh(1, 1)
    pred = {}
    try:
        for remat in (True, False):
            t0 = time.perf_counter()
            rec = dryrun.run_cell(TRAIN_ARCH, shape, mesh=mesh, cfg=cfg,
                                  microbatches=1, remat=remat)
            m = rec["memory"]
            pred[remat] = (m["argument_bytes"] + m["temp_bytes"]
                           + m["output_bytes"], rec,
                           time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    return pred


def train_4k_cell(card, dev, out):
    """(e) gemma2-2b at full size at train_4k's sequence length (batch 1 x
    seq 4096): the dry run's peak with remat and without beside the
    card's memory (a finding: the cell without remat is predicted, never
    run), then 1 warm-up and TRAIN_4K_TIMED timed steps through
    ``launch.train.run``, every block rematerialised: finite losses, the
    peak within MESH_MEMORY_TOL of the remat prediction, ms a step (CUDA
    events), tokens/s; one more step under torch.profiler."""
    from repro_torch import configs
    from repro_torch.launch import train

    cfg = configs.get(TRAIN_ARCH).config
    shape = configs.ShapeConfig(*TRAIN_4K_SHAPE)
    pred = train_4k_predict(cfg, shape)
    total = torch.cuda.get_device_properties(0).total_memory
    (on, rec, on_s), (off, _, off_s) = pred[True], pred[False]
    fits = {k: v[0] <= total for k, v in pred.items()}
    say(card, f"train (e) dry run of {TRAIN_ARCH} at full size, batch "
              f"{shape.global_batch} x seq {shape.seq_len} (one microbatch) "
              f"on a one-device cuda mesh: with remat {on} B "
              f"({on / 2**30:.2f} GiB; arguments "
              f"{rec['memory']['argument_bytes']} + temp "
              f"{rec['memory']['temp_bytes']} + outputs "
              f"{rec['memory']['output_bytes']}) in {on_s:.1f} s; without "
              f"remat {off} B ({off / 2**30:.2f} GiB) in {off_s:.1f} s; the "
              f"card's total_memory {total} B ({total / 2**30:.2f} GiB): "
              f"with remat fits {fits[True]}, without fits {fits[False]} "
              f"(not run)")
    args = train.parse(["--arch", TRAIN_ARCH, "--batch",
                        str(shape.global_batch), "--seq", str(shape.seq_len),
                        "--steps", str(1 + TRAIN_4K_TIMED)])
    tokens = args.batch * args.seq
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    marks = []
    real = train.make_train_step
    train.make_train_step = timed_step_factory(marks)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with count_remat() as entered:
            run = train.run(args)
    finally:
        train.make_train_step = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    if len(run.losses) != args.steps or not np.all(np.isfinite(run.losses)):
        raise AssertionError(f"train (e): losses {run.losses}")
    if len(entered) != args.steps * cfg.num_layers:
        raise AssertionError(f"train (e): {len(entered)} blocks "
                             f"rematerialised in {args.steps} steps")
    fb = [s.elapsed_time(e) for _, (s, e, _) in marks][1:]
    opt = [s.elapsed_time(e) for _, (_, s, e) in marks][1:]
    step = [a + b for a, b in zip(fb, opt)]
    med = {"step": statistics.median(step), "fb": statistics.median(fb),
           "opt": statistics.median(opt)}
    prof = {}
    train_profile(card, cfg, args, run, med, prof, "(e)")
    losses = run.losses
    del run
    gc.collect()
    torch.cuda.empty_cache()
    mem_err = abs(on - peak) / peak
    flop_ms = rec["counted"]["flops"] / BF16_FLOPS_PER_S * 1e3
    out["train_4k"] = dict(
        batch=args.batch, seq=args.seq, predicted_bytes=on,
        predicted_no_remat_bytes=off, total_memory=total, peak_bytes=peak,
        memory_error=mem_err, predicted_flops=rec["counted"]["flops"],
        flop_bound_ms=flop_ms, step_ms=step, fwd_bwd_ms=fb,
        optimizer_ms=opt, median_step_ms=med["step"],
        tokens_per_s=tokens / med["step"] * 1e3, run_s=wall,
        predict_s=[on_s, off_s], remat_blocks=len(entered), losses=losses,
        **prof)
    say(card, f"train (e) {TRAIN_ARCH} batch {args.batch} x seq {args.seq} "
              f"through launch.train.run, {args.steps} steps in {wall:.1f} "
              f"s ({len(entered)} blocks rematerialised), losses "
              f"{' '.join(f'{x:.4f}' for x in losses)} (finite): step ms "
              f"(CUDA events, after 1 warm-up) "
              f"{' '.join(f'{x:.2f}' for x in step)} -> median "
              f"{med['step']:.3f} = forward + recompute + backward "
              f"{med['fb']:.3f} + optimizer {med['opt']:.3f}; "
              f"{out['train_4k']['tokens_per_s']:.1f} tokens/s; the dry "
              f"run's FLOPs {rec['counted']['flops']} at "
              f"{BF16_FLOPS_PER_S:.4g} FLOP/s = {flop_ms:.3f} ms "
              f"({flop_ms / med['fb']:.1%} of forward + backward)")
    say(card, f"train (e) peak max_memory_allocated {peak} B "
              f"({peak / 2**30:.2f} GiB) over the {base} B in use before; "
              f"predicted with remat / measured {on / peak:.4f} (error "
              f"{mem_err:.4f}, tol {MESH_MEMORY_TOL}); without remat the "
              f"prediction is {off / total:.2f}x the card's memory")
    prev = TRAIN_4K_PREV
    say(card, f"train (e) this run beside the previous revision's "
              f"(constants from PERF.md section 6, not measured in this "
              f"run): median step {med['step']:.1f} ms (previous: "
              f"{prev['step_ms'][0]}-{prev['step_ms'][1]} ms); "
              f"max_memory_allocated {peak} B (previous: "
              f"{prev['peak_bytes']} B); predicted {on} B (previous: "
              f"{prev['predicted_bytes']} B); predicted / measured "
              f"{on / peak:.4f} (previous: {prev['predicted_over_peak']})")
    if mem_err > MESH_MEMORY_TOL:
        raise AssertionError(f"train (e): predicted {on} B, measured peak "
                             f"{peak} B")


def phase_train(card, dev, out):
    """Training (``data/``, ``optim/``, ``train/``, ``launch/train.py``) on
    the card: (a) every family's smoke config, three steps card vs host
    CPU; (b) gemma2-2b at full width and TRAIN_AGREE_LAYERS layers, loss
    and gradients card vs host CPU and remat vs not; (c) the timed cell,
    gemma2-2b at full width and depth through the launcher; (d) a resume
    at mamba2-130m's full size; (e) gemma2-2b at train_4k's sequence
    length, predicted and run.  Training runs no kernel of the port's
    cache path: the launch counters are set to 0 before (c) and read
    after it."""
    from repro_torch import configs

    gc.collect()
    torch.cuda.empty_cache()
    say(card, f"train: device memory in use at the start "
              f"{torch.cuda.memory_allocated()} B")
    t0 = time.perf_counter()
    worst = (0.0, "", 0.0, "")
    for arch in configs.ARCH_IDS:
        loss_err, leaf, err = train_agreement_family(card, arch, dev)
        if err >= worst[2]:
            worst = (max(loss_err, worst[0]), leaf, err, arch)
        else:
            worst = (max(loss_err, worst[0]),) + worst[1:]
    say(card, f"train (a) all {len(configs.ARCH_IDS)} smoke configs, "
              f"{TRAIN_AGREE_STEPS} make_train_step steps card vs host CPU "
              f"(AdamW {TRAIN_AGREE_OPT}): losses within {worst[0]:.3g} "
              f"relative (tol {TRAIN_LOSS_TOL}); step-1 gradients within "
              f"{worst[2]:.3g} relative L2 (worst {worst[3]} {worst[1]}; tol "
              f"{TRAIN_GRAD_TOL}) in {time.perf_counter() - t0:.1f} s")
    out.update(agree_loss_err=worst[0], agree_grad_err=worst[2])
    out.update(train_agreement_full_width(card, dev))
    gc.collect()
    torch.cuda.empty_cache()
    train_timed_cell(card, dev, out)
    train_resume_cell(card, out)
    train_4k_cell(card, dev, out)


# ---------------------------------------------------------------------------
# the mesh, the sharding rules and the dry run
# ---------------------------------------------------------------------------

#: (a) the mesh replay: the main trace's first requests, in BATCH chunks
#: (2^18: (d)'s subprocesses share the host's cores with it)
MESH_REPLAY_N = 2**18
#: (b) the trainer through make_dev_mesh(1, 1): gemma2-2b at full width,
#: TRAIN_AGREE_LAYERS layers, the launcher's batch, TRAIN_AGREE_OPT's lr
MESH_TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "3", "--lr", "1e-3"]
MESH_LOSS_TOL = 1e-6
#: (c) phase_train's timed cell (seq 128, batch 8, one microbatch as there)
#: predicted by the dry run on a one-device "cuda" mesh, then run for
#: real: 1 warm-up, 3 timed steps (the reference's 8 microbatches of one
#: sequence took 31.6 s to predict and 3.6-4.8 s a step)
MESH_CELL = ("train_1k", 128, 8, "train")
MESH_MICROBATCHES = 1
MESH_TIMED_STEPS = 3
MESH_MEMORY_TOL = 0.15
#: (d) production cells of the dry run on the fake 16x16 "cuda" mesh, one
#: subprocess each, run beside (a)-(c): mixtral-8x22b's decode, the largest
#: cache; internvl2-2b's and deepseek-7b's prefill, attention on head
#: shards (one KV head a rank pair; KV heads split as the queries);
#: gemma2-2b train_4k at full width cut to 2 layers (None: full depth),
#: the vocabulary-parallel loss over its 256k lanes (at full depth, 47-84
#: s of a host core, it would outlast (a)-(c); the CPU sweep runs every
#: cell at full depth)
MESH_DRYRUN_CELLS = (("mixtral-8x22b", "decode_32k", None),
                     ("internvl2-2b", "prefill_32k", None),
                     ("deepseek-7b", "prefill_32k", None),
                     ("gemma2-2b", "train_4k", 2))
#: the reference's temp bytes a device of each (d) cell, from its compiled
#: production artifact on a 16x16 mesh of Auto axes (tests/ref_dryrun_auto.py
#: on the CPU: the reference imports JAX, which this script does not); the
#: port's may be at most MESH_REF_FACTOR times as large
MESH_REF_TEMP = {("mixtral-8x22b", "decode_32k"): 72529599248,
                 ("internvl2-2b", "prefill_32k"): 2200331064,
                 ("deepseek-7b", "prefill_32k"): 5100174000,
                 ("gemma2-2b", "train_4k"): 7072525096}
MESH_REF_FACTOR = 2.0
MESH_DRYRUN_OUT = os.path.join(HERE, "chiprun_out", "dryrun")


@contextlib.contextmanager
def cut_depth(arch: str, layers: int):
    """``configs.get(arch).config`` with its depth cut to ``layers`` while
    the block runs (the launcher reads the config by name)."""
    import dataclasses
    from repro_torch import configs

    real = configs.get
    spec = real(arch)
    cut = dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, num_layers=layers))
    configs.get = lambda a: cut if a == arch else real(a)
    try:
        yield cut.config
    finally:
        configs.get = real


def mesh_replay(card, trace, dev, results, out):
    """(a) ``ShardedCache(mesh=...)`` on a one-device ``sets`` mesh against
    ``mesh=None``: MESH_REPLAY_N requests of the main trace in BATCH
    chunks, LRU and TinyLFU; every chunk's hits, values and evictions and
    the final lanes (and sketch) bit for bit.  The mesh runs are counted:
    kernel 2 a chunk, kernel 1 under TinyLFU."""
    from repro_torch.core import admission, kway
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.core.sharded import ShardedCache, ShardedConfig
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((1,), ("sets",), "cuda")
    trace = trace[:MESH_REPLAY_N]
    cfg = ShardedConfig(cache=KWayConfig(num_sets=NUM_SETS, ways=WAYS,
                                         policy=Policy.LRU), num_shards=1)
    for label, tl, kernels in (
            ("LRU", None, ("kway_fused_probe",)),
            ("TinyLFU", admission.for_capacity(NUM_SETS * WAYS),
             ("kway_fused_probe", "kway_probe"))):
        runs, secs = [], []
        for m in (None, mesh):
            sc = ShardedCache(cfg, m, device=dev)
            st = sc.init()
            sk = sc.init_sketches(tl) if tl is not None else None
            outs = []
            if m is not None:
                reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            for c in range(0, len(trace), BATCH):
                keys = trace[c:c + BATCH]
                kw = {} if tl is None else {"tinylfu": tl, "sketches": sk}
                st, *o = sc.access(st, keys, keys.astype(np.int32), **kw)
                if tl is not None:
                    sk = o.pop()
                outs.append(torch.stack([x.to(torch.int32) for x in o]))
            sync(dev)
            secs.append(time.perf_counter() - t0)
            if m is not None:
                check_launches(card, f"mesh replay {label}", kernels,
                               results)
            runs.append((torch.stack(outs), kway.state_to_numpy(st),
                         None if sk is None else
                         admission.sketch_to_numpy(sk)))
        (a, sa, ka), (b, sb, kb) = runs
        if not torch.equal(a, b):
            raise AssertionError(f"mesh replay {label}: chunk outputs "
                                 f"differ from mesh=None")
        for leaf in sa:
            np.testing.assert_array_equal(sa[leaf], sb[leaf],
                                          err_msg=f"mesh {label} {leaf}")
        for leaf in (ka or {}):
            np.testing.assert_array_equal(ka[leaf], kb[leaf],
                                          err_msg=f"mesh {label} {leaf}")
        hits = int(a[:, 0].sum())
        say(card, f"mesh (a) ShardedCache on a one-device 'sets' mesh "
                  f"({label}, {len(trace)} requests, {a.shape[0]} chunks of "
                  f"{BATCH}): hits {hits}, every chunk's outputs and the "
                  f"final lanes{' and sketch' if ka else ''} equal to "
                  f"mesh=None; {secs[1]:.2f} s on the mesh, {secs[0]:.2f} s "
                  f"without (one all_gather_into_tensor a chunk)")
        out[f"replay_{label}_s"] = secs


def mesh_train(card, out):
    """(b) ``launch.train.run`` through ``make_dev_mesh(1, 1)`` (DTensor
    parameters, all replicated) against the plain run: gemma2-2b at full
    width, TRAIN_AGREE_LAYERS layers, 3 steps, deterministic algorithms
    (every backward op adds in one order); losses equal."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    mesh = mesh_lib.make_dev_mesh(1, 1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with cut_depth(TRAIN_ARCH, TRAIN_AGREE_LAYERS):
            t0 = time.perf_counter()
            on = train.run(train.parse(MESH_TRAIN_ARGS), mesh=mesh)
            t1 = time.perf_counter()
            off = train.run(train.parse(MESH_TRAIN_ARGS))
            t2 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(False)
    err = max(abs(a / b - 1) for a, b in zip(on.losses, off.losses))
    if err > MESH_LOSS_TOL:
        raise AssertionError(f"mesh (b): losses {on.losses} on the mesh, "
                             f"{off.losses} without")
    say(card, f"mesh (b) launch.train.run through make_dev_mesh(1, 1), "
              f"{TRAIN_ARCH} full width {TRAIN_AGREE_LAYERS} layers, 3 "
              f"steps: losses {on.losses} vs {off.losses} without a mesh "
              f"(max relative difference {err:.3g}, tol {MESH_LOSS_TOL}); "
              f"{t1 - t0:.2f} s / {t2 - t1:.2f} s")
    out["train_loss_err"] = err
    del on, off
    gc.collect()
    torch.cuda.empty_cache()


def mesh_predict_and_measure(card, dev, out):
    """(c) The dry run's prediction of phase_train's timed cell (gemma2-2b,
    seq 128 x batch 8, one microbatch) on a one-device "cuda" mesh under
    FakeTensorMode, then the same ``build_train_fn`` step for real on the
    card: the peak device memory of one step against the predicted
    arguments + temp + outputs (within MESH_MEMORY_TOL), the FLOPs counted
    by the same ``StepCounter`` (equal), and ms a step against the
    roofline's ``step_time`` (a finding, no limit)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, DataState, \
        SyntheticPipeline
    from repro_torch.launch import dryrun, train
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = mesh_lib.make_dev_mesh(1, 1)
    cfg = configs.get(TRAIN_ARCH).config
    shape = configs.ShapeConfig(*MESH_CELL)
    t0 = time.perf_counter()
    pred = dryrun.run_cell(TRAIN_ARCH, shape, mesh=mesh, cfg=cfg,
                           microbatches=MESH_MICROBATCHES)
    fake_s = time.perf_counter() - t0
    mem = pred["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"]

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = train.parse(["--arch", TRAIN_ARCH, "--seq", str(shape.seq_len),
                        "--batch", str(shape.global_batch)])
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=shape.seq_len,
                                        global_batch=shape.global_batch))
    batch = train.make_batch(cfg, args, *pipe.batch(DataState()), dev)
    model = lm.init_params(cfg, seed=0, device=dev)
    fn, fargs, tensors = dryrun.place_cell(
        cfg, shape, mesh, dev, batch=batch, model=model,
        microbatches=MESH_MICROBATCHES)
    del model, batch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, counter, real_mem = dryrun.count_step(fn, fargs, tensors)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    marks = []
    for _ in range(MESH_TIMED_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        with implicit_replication():
            fn(*fargs)
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in marks]
    step_ms = statistics.median(ms)
    rf = pred["roofline"]
    mem_err = abs(predicted - peak) / peak
    say(card, f"mesh (c) dry run of {TRAIN_ARCH} {shape.name} (seq "
              f"{shape.seq_len} x batch {shape.global_batch}, "
              f"{MESH_MICROBATCHES} microbatch) on a "
              f"one-device cuda mesh under FakeTensorMode in {fake_s:.1f} s:"
              f" arguments {mem['argument_bytes']} B + temp "
              f"{mem['temp_bytes']} B + outputs {mem['output_bytes']} B = "
              f"{predicted} B; FLOPs {pred['counted']['flops']}; roofline "
              f"step_time {rf['step_time'] * 1e3:.3f} ms "
              f"({rf['bottleneck']}), roofline_fraction "
              f"{rf['roofline_fraction']:.4f}")
    say(card, f"mesh (c) the same step on the card: peak "
              f"max_memory_allocated {peak} B over the {base} B in use "
              f"before (predicted / measured {predicted / peak:.4f}, error "
              f"{mem_err:.4f}, tol {MESH_MEMORY_TOL}); counted FLOPs "
              f"{counter.flops} (the dry run's {pred['counted']['flops']}); "
              f"counted step {counted_s:.1f} s; ms a step (CUDA events, "
              f"{MESH_TIMED_STEPS} after the counted one) {ms} -> median "
              f"{step_ms:.3f}; / roofline step_time "
              f"{step_ms / (rf['step_time'] * 1e3):.2f}x")
    out.update(predicted_bytes=predicted, peak_bytes=peak,
               memory_error=mem_err, flops_fake=pred["counted"]["flops"],
               flops_real=counter.flops, step_ms=ms,
               roofline_step_ms=rf["step_time"] * 1e3,
               roofline_fraction=rf["roofline_fraction"],
               fake_run_s=fake_s, real_memory=real_mem)
    if mem_err > MESH_MEMORY_TOL:
        raise AssertionError(f"mesh (c): predicted {predicted} B, measured "
                             f"peak {peak} B")
    if counter.flops != pred["counted"]["flops"]:
        raise AssertionError(f"mesh (c): FLOPs {counter.flops} on the card, "
                             f"{pred['counted']['flops']} predicted")
    del fn, fargs, tensors
    gc.collect()
    torch.cuda.empty_cache()


def start_dryrun_cells() -> list:
    """(d) One ``python -m repro_torch.launch.dryrun`` per production cell
    on the fake 16x16 "cuda" mesh, started now and read by
    ``finish_dryrun_cells``."""
    os.makedirs(MESH_DRYRUN_OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for arch, shape, layers in MESH_DRYRUN_CELLS:
        path = os.path.join(MESH_DRYRUN_OUT, f"{arch}_{shape}.json")
        if os.path.exists(path):
            os.remove(path)
        log = open(path[:-5] + ".log", "w")
        cut = [] if layers is None else ["--layers", str(layers)]
        procs.append((arch, shape, path, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--skip-multi-pod", "--mesh-device",
             "cuda", "--out", path] + cut, env=env, stdout=log,
            stderr=subprocess.STDOUT), time.perf_counter()))
    return procs


def finish_dryrun_cells(card, procs, out, timeout=600):
    for arch, shape, path, log, proc, t0 in procs:
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        with open(path) as f:
            rec = json.load(f)[f"{arch}|{shape}|single"]
        if rc != 0 or rec.get("status") != "ok":
            raise AssertionError(f"mesh (d) {arch} {shape}: rc {rc}, "
                                 f"{rec.get('error')}")
        m = rec["memory"]
        gib = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]) \
            / 2**30
        r = rec["roofline"]
        ref = MESH_REF_TEMP[(arch, shape)]
        depth = (f", {rec['layers']} layers" if "layers" in rec
                 else "")
        say(card, f"mesh (d) dry run {arch} {shape}{depth} on the fake "
                  f"16x16 {rec['mesh_device']} mesh: ok in "
                  f"{rec['compile_s']} s (process "
                  f"{time.perf_counter() - t0:.1f} s wall), {gib:.2f} GiB "
                  f"per device (arguments "
                  f"{m['argument_bytes'] / 2**30:.2f}, temp "
                  f"{m['temp_bytes'] / 2**30:.2f}; the reference's temp "
                  f"{ref / 2**30:.2f} GiB, a constant: port / reference "
                  f"{m['temp_bytes'] / ref:.3f}, limit {MESH_REF_FACTOR}), "
                  f"collectives {r['coll_breakdown']}, step_time "
                  f"{r['step_time']:.4f} s ({r['bottleneck']})")
        out[f"dryrun_{arch}_{shape}"] = {
            "s": rec["compile_s"], "gib_per_device": gib,
            "temp_bytes": m["temp_bytes"], "ref_temp_bytes": ref,
            "coll_breakdown": r["coll_breakdown"],
            "step_time": r["step_time"], "bottleneck": r["bottleneck"]}
        if m["temp_bytes"] > MESH_REF_FACTOR * ref:
            raise AssertionError(f"mesh (d) {arch} {shape}: temp "
                                 f"{m['temp_bytes']} B, over "
                                 f"{MESH_REF_FACTOR} x the reference's {ref}")


def phase_mesh_dryrun(card, trace, dev, results, out):
    """The mesh slice on one card: (d)'s dry-run cells start in
    subprocesses, then (a) the sharded cache on a one-device mesh, (b) the
    trainer through a one-device mesh and (c) the dry run's prediction
    held against the real step, all on one one-rank NCCL group (an
    in-memory store: no rendezvous); then (d) is read.  The group is
    destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    procs = start_dryrun_cells()
    try:
        mesh_lib.ensure_group(1, "cuda")
        try:
            t0 = time.perf_counter()
            mesh_replay(card, trace, dev, results, out)
            t1 = time.perf_counter()
            mesh_train(card, out)
            t2 = time.perf_counter()
            mesh_predict_and_measure(card, dev, out)
            t3 = time.perf_counter()
        finally:
            dist.destroy_process_group()
        finish_dryrun_cells(card, procs, out)
    finally:
        for *_, log, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say(card, f"mesh phase parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
              f"(c) {t3 - t2:.1f} s, (d) waited "
              f"{time.perf_counter() - t3:.1f} s more")


# ---------------------------------------------------------------------------
# set sharding and the robustness layer
# ---------------------------------------------------------------------------

#: shard counts of the sharded resident replay on the main path's trace
SHARD_COUNTS = (1, 2, 4, 8)
#: requests of the checks against the sharded torch twin on the card
SHARD_TWIN_N = 2**17
#: requests of the chunked sharded path (kernel 2 per shard per chunk)
SHARD_CHUNKED_N = 2**19
#: overflow-defer: D = 8 shards, 256 and 128 lanes a bucket (a chunk of
#: 1024 lanes; on this trace no bucket passes 256, and 128 defers)
SHARD_DEFER = dict(shards=8, capacities=(256, 128))
#: the sharded hierarchy (a private L1 of 512 x 16 per shard): D and the
#: requests kernel 4's plain version walks
SHARD_HIER = dict(shards=2, n=2**14)
#: the validator's cadence in validated_replay (chunks)
VALIDATE_INTERVAL = 64
#: the checkpoint phase: deepseek-7b at full width cut to CKPT_LAYERS
#: layers (a 30-layer checkpoint of the tick holds 8.06 GB of pools), a
#: commit every CKPT_EVERY ticks, the crash one tick after it
CKPT_LAYERS, CKPT_EVERY = 4, 4
#: where the checkpoint phase writes (inside the checkout, removed after)
CKPT_DIR = os.path.join(HERE, ".chip_smoke_ckpt")


def stacked_err(a, b) -> int:
    """Largest |a - b| over every tensor field of two states (any
    dataclass of tensors, nested: a stacked KWayState, a HierState, a
    sketch); fields must match in presence and shape."""
    import dataclasses
    err = 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            raise AssertionError(f"{f.name} present on one side only")
        if x is None:
            continue
        if dataclasses.is_dataclass(x):
            err = max(err, stacked_err(x, y))
        else:
            err = max(err, max_abs_err([(x.reshape(-1), y.reshape(-1))]))
    return err


def phase_sharded_replay(card, trace, ttl_trace, dev, results):
    """Set sharding (``core/sharded.py``) on the main path's state and
    trace, counted: LRU resident at D in SHARD_COUNTS (D kernel-3 launches
    each; hits and the global view's keys and vals equal the unsharded
    kernel-3 run), ``replay_batched(shards=4, resident=True)``; HYPERBOLIC
    and per-shard TinyLFU at D = 4 against the sharded torch twin on the
    card (every lane, and every shard's sketch word); TTL at D = 2 equal to
    the unsharded TTL replay; overflow-defer at D = 8 against the twin; the
    chunked sharded path (kernel 2 per shard per chunk) equal to the
    resident one; the sharded hierarchy (kernel 4 per shard) against
    kernel 4's plain version.  Then each D timed."""
    from repro_torch.core import admission, hashing, router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.core.sharded import (ShardedCache, ShardedConfig,
                                          shard_of)
    from repro_torch.kernels import replay as krp

    def cache(cfg, d, backend="cuda", device=dev, **kw):
        return ShardedCache(ShardedConfig(cache=cfg, num_shards=d,
                                          backend=backend, **kw),
                            device=device)

    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    be = make_backend("cuda", cfg, dev)
    chunks, en = router.pad_chunks(trace, BATCH)
    h0, _, s0, _ = be.replay(be.init(), chunks, en)
    hits0 = int(h0.sum())

    reset_launch_counts()
    for d in SHARD_COUNTS:
        before = krp.launches("flat")
        hits, defers, st = cache(cfg, d).replay(trace, BATCH, resident=True)
        n = krp.launches("flat") - before
        gv = cache(cfg, d).global_view(st)
        if n != d or (hits, defers) != (hits0, 0) or not (
                torch.equal(gv.keys, s0.keys)
                and torch.equal(gv.vals, s0.vals)):
            raise AssertionError(f"sharded LRU D={d}: {n} kernel-3 launches,"
                                 f" hits {hits} deferred {defers}, unsharded"
                                 f" hits {hits0}, or global view keys/vals "
                                 f"differ")
        say(card, f"sharded resident LRU D={d}: {n} kernel-3 launches, hits "
                  f"{hits} == unsharded kernel 3, global view keys and vals "
                  f"== unsharded, clocks {st.clock.tolist()}")
    hr = simulate.replay_batched(
        simulate.SimConfig(cfg, backend="cuda", device=dev), trace,
        batch=BATCH, shards=4, resident=True)
    if hr != hits0 / len(trace):
        raise AssertionError(f"replay_batched(shards=4) hit ratio {hr!r}")
    say(card, f"simulate.replay_batched(shards=4, resident=True): hit ratio "
              f"{hr!r} == unsharded")

    tr = trace[:SHARD_TWIN_N]
    err = 0
    for policy, tl in ((Policy.HYPERBOLIC, None),
                       (Policy.LRU, admission.for_capacity(NUM_SETS * WAYS))):
        c = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=policy)
        kern, twin = cache(c, 4), cache(c, 4, "torch")
        got = kern.replay(tr, BATCH, resident=True, tinylfu=tl)
        want = twin.replay(tr, BATCH, resident=True, tinylfu=tl)
        e = stacked_err(got[2], want[2])
        if got[:2] != want[:2] or e:
            raise AssertionError(f"sharded {policy.name} tinylfu="
                                 f"{tl is not None} D=4: {got[:2]} vs twin "
                                 f"{want[:2]}, state err {e}")
        if tl is not None:
            # every shard's sketch: the same per-shard calls as the replay
            tch, ten = router.pad_chunks(tr, BATCH)
            kc, ec, _, _ = kern.bucket_all(hashing.key_tensor(tch, dev),
                                           torch.from_numpy(ten).to(dev),
                                           BATCH)
            st_k, st_t = kern.init(), twin.init()
            for i in range(4):
                _, _, _, sk = kern.backend.replay(
                    shard_of(st_k, i), kc[i], ec[i], tinylfu=tl)
                _, _, _, sk2 = twin.backend.replay(
                    shard_of(st_t, i), kc[i], ec[i], tinylfu=tl)
                e = max(e, stacked_err(sk, sk2))
            if e:
                raise AssertionError(f"sharded TinyLFU D=4: a shard's sketch "
                                     f"differs from the twin's (err {e})")
        err = max(err, e)
        say(card, f"sharded resident {policy.name}"
                  f"{' + TinyLFU (per-shard sketches)' if tl else ''} D=4, "
                  f"{len(tr)} requests: hits {got[0]} == sharded torch twin "
                  f"on the card, every lane{' and sketch word' if tl else ''}")

    keys, ttls = ttl_trace
    tcfg = KWayConfig(num_sets=TTL_SETS, ways=WAYS, policy=Policy.LRU)
    tbe = make_backend("cuda", tcfg, dev)
    tch, ten = router.pad_chunks(keys, TTL_BATCH)
    th0, _, ts0, _ = tbe.replay(tbe.init(ttl=True), tch, ten,
                                ttls=simulate._pad_ttl_chunks(ttls,
                                                              TTL_BATCH))
    sc2 = cache(tcfg, 2)
    hits, defers, st = sc2.replay(keys, TTL_BATCH, resident=True, ttls=ttls)
    gv = sc2.global_view(st)
    if (hits, defers) != (int(th0.sum()), 0) or not (
            torch.equal(gv.keys, ts0.keys) and torch.equal(gv.vals, ts0.vals)
            and torch.equal(gv.expiry, ts0.expiry)):
        raise AssertionError(f"sharded TTL D=2: hits {hits} vs unsharded "
                             f"{int(th0.sum())}, or the global view differs")
    say(card, f"sharded resident TTL D=2 (ttl_churn {len(keys)}, S="
              f"{TTL_SETS}): hits {hits} == unsharded, global view keys, "
              f"vals and deadlines == unsharded")

    d = SHARD_DEFER["shards"]
    deferred = {}
    for cap in SHARD_DEFER["capacities"]:
        got = cache(cfg, d, route_capacity=cap).replay(tr, BATCH,
                                                       resident=True)
        want = cache(cfg, d, "torch", route_capacity=cap).replay(
            tr, BATCH, resident=True)
        e = stacked_err(got[2], want[2])
        if got[:2] != want[:2] or e:
            raise AssertionError(f"overflow-defer D={d} capacity {cap}: "
                                 f"{got[:2]} vs twin {want[:2]} (err {e})")
        deferred[cap] = got[1]
        say(card, f"sharded overflow-defer D={d}, route_capacity={cap}, "
                  f"{len(tr)} requests: deferred {got[1]}, hits {got[0]} == "
                  f"twin, every lane")
    if not any(deferred.values()):
        raise AssertionError(f"overflow-defer deferred nothing: {deferred}")

    trc = trace[:SHARD_CHUNKED_N]
    sc4 = cache(cfg, 4)
    t0 = time.perf_counter()
    chk = sc4.replay(trc, BATCH)
    sync(dev)
    wall = time.perf_counter() - t0
    res = sc4.replay(trc, BATCH, resident=True)
    e = stacked_err(chk[2], res[2])
    if chk[:2] != res[:2] or e:
        raise AssertionError(f"sharded chunked D=4 {chk[:2]} != resident "
                             f"{res[:2]} (err {e})")
    say(card, f"sharded chunked path D=4 (kernel 2 per shard per chunk), "
              f"{len(trc)} requests: hits {chk[0]} == resident, every lane "
              f"({wall:.2f} s host wall: {len(trc) / wall:.0f} requests/s)")

    hd, hn = SHARD_HIER["shards"], SHARD_HIER["n"]
    hc = HierarchyConfig(l1_sets=HIER_L1_SETS, l1_ways=HIER_L1_WAYS)
    before = krp.launches("hier")
    got = cache(cfg, hd).replay(trace[:hn], BATCH, resident=True,
                                hierarchy=hc)
    n = krp.launches("hier") - before
    want = cache(cfg, hd, "torch", torch.device("cpu")).replay(
        trace[:hn], BATCH, resident=True, hierarchy=hc)
    e = stacked_err(got[2], want[2])
    if n != hd or got[:2] != want[:2] or e:
        raise AssertionError(f"sharded hierarchy D={hd}: {n} launches, "
                             f"{got[:2]} vs plain {want[:2]} (err {e})")
    say(card, f"sharded hierarchy D={hd} (L1 {HIER_L1_SETS}x{HIER_L1_WAYS} "
              f"per shard over L2 {NUM_SETS // hd}x{WAYS} each), {hn} "
              f"requests: {n} kernel-4 launches, hits {got[0]} == kernel 4's "
              f"plain version (CPU tensors), both tiers of every shard")
    check_launches(card, "sharded replay", (
        "kway_fused_probe", "replay_resident", "replay_resident_tinylfu",
        "replay_hierarchical"), results)

    # timing from the host trace, in turns (0, 1, 2, 4, 8, 8, 4, 2, 1, 0):
    # unsharded (D = 0 below: ``replay_batched(resident=True)``) and
    # ``ShardedCache.replay(resident=True)`` at each D (what
    # ``replay_batched(shards=D)`` runs); kernel 3's device time per shard
    # launch from torch.profiler; the routing alone on device tensors
    qk = hashing.key_tensor(chunks, dev)
    ent = torch.from_numpy(en).to(dev)
    sim = simulate.SimConfig(cfg, backend="cuda", device=dev)
    order = (0,) + SHARD_COUNTS
    wall = {d: [] for d in order}
    for d in order + order[::-1]:
        run = ((lambda: simulate.replay_batched(sim, trace, batch=BATCH,
                                                resident=True)) if d == 0
               else (lambda: cache(cfg, d).replay(trace, BATCH,
                                                  resident=True)))
        wall[d].append(timed(run)[1])
    timing = {}
    for d in order:
        ms = statistics.median(wall[d])
        if d == 0:
            say(card, f"unsharded resident LRU (replay_batched): "
                      f"{wall[0]} ms per replay (CUDA events, in turns with "
                      f"the sharded runs), median {ms:.3f} ms = "
                      f"{len(trace) / ms * 1e3:.4g} requests/s")
            timing["unsharded"] = dict(ms=ms,
                                       requests_per_s=len(trace) / ms * 1e3)
            continue
        sc = cache(cfg, d)
        dev_ms = profiled_device_ms(
            lambda: sc.replay(trace, BATCH, resident=True), 1,
            KERNEL3_NAMES, warmup=False)
        route_ms = cuda_ms(lambda: sc.bucket_all(qk, ent, BATCH), 5)
        timing[d] = dict(ms=ms, requests_per_s=len(trace) / ms * 1e3,
                         kernel3_device_ms_per_launch=dev_ms and dev_ms / d,
                         routing_ms=route_ms, launches=d)
        say(card, f"sharded resident LRU D={d} (ShardedCache.replay): "
                  f"{wall[d]} ms per replay (CUDA events, host padding, "
                  f"copies and routing included), median {ms:.3f} ms = "
                  f"{len(trace) / ms * 1e3:.4g} requests/s; kernel 3 "
                  f"{fmt_ms(dev_ms and dev_ms / d)} device per shard launch "
                  f"(torch.profiler, {d} launches); routing (bucket_all, "
                  f"device tensors) {route_ms:.3f} ms")
    results["replay_resident"].update(
        sharded_timing=timing, max_abs_err_sharded=err)


def phase_sharded_serve(card, dev, results, serve):
    """The serving host loop with a sharded prefix cache
    (``EngineConfig(shards=D)``, cuda backend) at full width, counted:
    tokens, stats, hit ratio and evictions equal to ``phase_serve_path``'s
    ``shards=1`` run at D = 2 and 4; then tokens/s of D = 1, 2, 4, one
    timed run each."""
    cfg = serve_config()
    model, prompts = serve["model"], serve["prompts"]
    hst, hreqs, _, hhr = serve["host"]
    reset_launch_counts()
    for shards in (2, 4):
        st, reqs, wall, hr = drive_engine(cfg, model, "cuda", prompts, dev,
                                          shards=shards)
        if (st, reqs, hr) != (hst, hreqs, hhr):
            bad = [rid for rid in reqs if reqs[rid] != hreqs.get(rid)]
            raise AssertionError(f"shards={shards}: stats {st}, hit ratio "
                                 f"{hr!r} vs shards=1 {hst}, {hhr!r}; "
                                 f"requests differing {bad}")
        n_tok = sum(len(t) for t, _, _ in reqs.values())
        say(card, f"sharded serving shards={shards}: tokens, pages, prefix "
                  f"hits of all {len(reqs)} requests, stats {st} and hit "
                  f"ratio {hr!r} == shards=1 ({n_tok} tokens in {wall:.3f} "
                  f"s)")
    counts = launch_counts()
    say(card, f"sharded serving launches (kernels 2, 1, 5): "
              f"{counts['kway_fused_probe']}, {counts['kway_probe']}, "
              f"{counts['paged_attention']}")
    check_launches(card, "sharded serving", ("kway_probe",
                                             "paged_attention"), results)
    rates = {1: [], 2: [], 4: []}
    for shards in (1, 2, 4):
        st, reqs, wall, _ = drive_engine(cfg, model, "cuda", prompts, dev,
                                         shards=shards)
        n_tok = sum(len(t) for t, _, _ in reqs.values())
        rates[shards].append(n_tok / wall)
        say(card, f"sharded serving timing shards={shards}: {n_tok} tokens "
                  f"in {wall:.4f} s = {n_tok / wall:.2f} tokens/s")
    results["paged_attention"].update(serve_sharded_tokens_per_s=rates)


def phase_robust(card, trace, ttl_trace, dev, results):
    """The robustness layer on the main path's state, counted:
    ``check_cache`` clean on the final 2^20-entry state; every fault site
    detected at its named set / way, ``scrub`` on the card equal to
    ``scrub`` of the same state on the CPU; ``check_cache`` and ``scrub``
    timed beside their bytes bound; ``validated_replay`` (cuda, interval
    VALIDATE_INTERVAL) on the whole trace equal to the main path's hits;
    ``resilient_replay`` on its top rung with no event, flat and with the
    hierarchy."""
    from repro_torch.core import hashing, router, simulate
    from repro_torch.core.backend import make_backend
    from repro_torch.core.hierarchy import HierarchyConfig, make_hier
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import ops
    from repro_torch.robust import (check_cache, check_hier, events,
                                    explain_cache, explain_hier, faults,
                                    resilient_replay, scrub, scrub_hier,
                                    validated_replay)

    cfg = KWayConfig(num_sets=NUM_SETS, ways=WAYS, policy=Policy.LRU)
    be = make_backend("cuda", cfg, dev)
    chunks, en = router.pad_chunks(trace, BATCH)
    h0, _, s0, _ = be.replay(be.init(), chunks, en)
    hits0 = int(h0.sum())
    reset_launch_counts()
    rep = check_cache(cfg, s0, vals_mode="key")
    if not rep.clean():
        raise AssertionError(f"main path state not clean: "
                             f"{explain_cache(rep, limit=8)}")

    def repair_matches_cpu(c, st, label, hier=None):
        """scrub (scrub_hier) on the card == on the CPU, bit for bit."""
        if hier is None:
            a = scrub(c, st, vals_mode="key")
            b = scrub(c, to_cpu(st), vals_mode="key")
        else:
            a = scrub_hier(c, hier, st, vals_mode="key")
            b = scrub_hier(c, hier, to_cpu(st), vals_mode="key")
            a, b = (a[0], a[1], torch.cat([x.reshape(-1) for x in a[2]])), \
                (b[0], b[1], torch.cat([x.reshape(-1) for x in b[2]]))
        e = stacked_err(a[0], b[0]) + max_abs_err([(a[1].reshape(1),
                                                    b[1].reshape(1)),
                                                   (a[2], b[2])])
        if e or int(a[1]) <= 0:
            raise AssertionError(f"{label}: scrub on the card != on the CPU "
                                 f"(err {e}) or nothing scrubbed")
        return int(a[1])

    def named(rep, s, w, what):
        """``what`` among the names of lane (s, w)'s violation bits."""
        from repro_torch.robust import invariants
        bits = int(rep.lane_bits[s, w])
        names = [n for i, n in invariants.CACHE_CHECKS.items()
                 if bits >> i & 1]
        if what not in names:
            raise AssertionError(f"{what} not named at set {s} way {w}: "
                                 f"{names}; {explain_cache(rep)[:6]}")

    for i, site in enumerate(faults.LANE_SITES):
        st2, fr = faults.flip_bit(s0, site, seed=2026, step=i)
        lines = explain_cache(check_cache(cfg, st2, vals_mode="key"))
        s, w = fr.index
        if not any(f"set {s} way {w}:" in ln for ln in lines):
            raise AssertionError(f"flip_bit {site} at ({s}, {w}) not named: "
                                 f"{lines[:6]}")
        forced = repair_matches_cpu(cfg, st2, f"flip_bit {site}")
        say(card, f"flip_bit {site} bit {fr.bit} at set {s} way {w}: "
                  f"detected and named ({lines[0]}); scrub on the card == "
                  f"CPU, {forced} forced evictions")
    keys, ttls = ttl_trace
    tcfg = KWayConfig(num_sets=TTL_SETS, ways=WAYS, policy=Policy.LRU)
    tbe = make_backend("cuda", tcfg, dev)
    tch, ten = router.pad_chunks(keys, TTL_BATCH)
    _, _, ts, _ = tbe.replay(tbe.init(ttl=True), tch, ten,
                             ttls=simulate._pad_ttl_chunks(ttls, TTL_BATCH))
    for kind, bit in (("stale_entry", "expired_hit"),
                      ("clock_skew", "expired_resident")):
        st2, fr = getattr(faults, kind)(ts, seed=2026)
        named(check_cache(tcfg, st2, vals_mode="key"), *fr.index, bit)
        forced = repair_matches_cpu(tcfg, st2, kind)
        say(card, f"{kind} at set {fr.index[0]} way {fr.index[1]}: {bit} "
                  f"named; scrub on the card == CPU, {forced} forced "
                  f"evictions")
    hc = HierarchyConfig(l1_sets=HIER_L1_SETS, l1_ways=HIER_L1_WAYS)
    hch, hen = router.pad_chunks(trace[:HIER_CHECK_N], BATCH)
    _, _, hst, _ = ops.replay_hierarchical(cfg, hc, make_hier(
        cfg, hc, device=dev), hch, hen)
    if not check_hier(cfg, hc, hst, vals_mode="key").clean():
        raise AssertionError("hierarchy state not clean")
    st2, fr = faults.double_resident(cfg, hst, seed=2026)
    dup = hashing.key_tensor(np.asarray([int(fr.after)], np.uint32), dev)
    s1, w1 = (int(v) for v in torch.nonzero(st2.l1.keys == dup[0])[0])
    lines = explain_hier(check_hier(cfg, hc, st2, vals_mode="key"))
    if f"l1 set {s1} way {w1}: double_resident" not in lines:
        raise AssertionError(f"double_resident not named at L1 set {s1} "
                             f"way {w1}: {lines[:6]}")
    forced = repair_matches_cpu(cfg, st2, "double_resident", hier=hc)
    say(card, f"double_resident (L2 set {fr.index[0]} way {fr.index[1]}): "
              f"named at L1 set {s1} way {w1}; scrub_hier on the card == "
              f"CPU, {forced} forced evictions")

    n_ent = NUM_SETS * WAYS
    check_ms = cuda_ms(lambda: check_cache(cfg, s0, vals_mode="key"), 10)
    scrub_ms = cuda_ms(lambda: scrub(cfg, s0, vals_mode="key"), 10)
    b_check = (5 * 4 + 4) * n_ent
    b_scrub = (5 * 4 + 5 * 4 + 4) * n_ent
    say(card, f"check_cache at {n_ent} entries: {check_ms:.4f} ms per call "
              f"(CUDA events), bound {b_check / HBM_BYTES_PER_S * 1e3:.6f} "
              f"ms ({b_check} B: 5 lanes read, the bitmap written); scrub "
              f"{scrub_ms:.4f} ms, bound "
              f"{b_scrub / HBM_BYTES_PER_S * 1e3:.6f} ms ({b_scrub} B: 5 "
              f"lanes read and written, the bitmap)")

    t0 = time.perf_counter()
    vh, _, vst, _, alarm = validated_replay(
        cfg, chunks, en, backend="cuda", interval=VALIDATE_INTERVAL,
        device=dev)
    sync(dev)
    vwall = time.perf_counter() - t0
    if int(vh.sum()) != hits0 or int(alarm) != 0 or stacked_err(vst, s0):
        raise AssertionError(f"validated_replay: hits {int(vh.sum())} vs "
                             f"{hits0}, alarm {int(alarm)}")
    say(card, f"validated_replay (cuda, interval {VALIDATE_INTERVAL}) on "
              f"{len(trace)} requests: hits {hits0} == main path, final "
              f"state == kernel 3's, alarm 0 ({vwall:.2f} s host wall)")

    c0 = events.cursor()
    out = resilient_replay(cfg, chunks, en, device=dev)
    if out.rung != "cuda-resident" or events.count(start=c0) \
            or int(out.hits.sum()) != hits0:
        raise AssertionError(f"resilient_replay: rung {out.rung}, attempts "
                             f"{out.attempts}, events "
                             f"{events.since(c0)}")
    outh = resilient_replay(cfg, chunks, en, device=dev, hierarchy=hc)
    if outh.rung != "cuda-resident-l1l2" or events.count(start=c0):
        raise AssertionError(f"resilient_replay (hierarchy): rung "
                             f"{outh.rung}, attempts {outh.attempts}, events"
                             f" {events.since(c0)}")
    say(card, f"resilient_replay: {out.attempts} (hits {hits0}); with the "
              f"hierarchy {outh.attempts} (hits {int(outh.hits.sum())}); no "
              f"degradation event")
    check_launches(card, "robust", ("kway_fused_probe", "replay_resident",
                                    "replay_hierarchical"), results)


def tick_launches(eng) -> Counter:
    """Kernel launches of a tick engine's run so far: each graph's launches
    at capture times its replays."""
    return Counter({k: sum(eng.graph_launches[kind].get(k, 0) * n
                           for kind, n in eng.ticks.items())
                    for k in TICK_KERNELS})


def phase_robust_serve(card, dev, results, serve):
    """The robustness layer on the tick (``jitted=True``, cuda backend):
    ``check_serve`` clean mid-run and drained at full width, ``inject_nan``
    named ``nan_in_kv`` and ``double_book_page`` named ``double_booked``;
    then, at full width and CKPT_LAYERS layers, a crash mid-tick: a
    ``CheckpointedEngine`` commits every CKPT_EVERY ticks, the next tick's
    save never commits, and a fresh engine (graphs captured) restored from
    the commit runs to the end with every request's tokens and the stats
    of an uninterrupted run."""
    import dataclasses
    import shutil
    from repro_torch.ckpt import manager
    from repro_torch.models import lm
    from repro_torch.robust import (CheckpointedEngine, check_serve,
                                    explain_serve, faults, restore_engine,
                                    save_engine)

    cfg = serve_config()
    model, prompts = serve["model"], serve["prompts"]
    e = SERVE_ENGINE
    pages = e["num_sets"] * e["ways"] + e["private_pages"]
    launches = Counter()
    eng, _, _ = build_tick(cfg, model, dev)
    for p in prompts:
        eng.submit(p, max_new=SERVE_MAX_NEW)
    for _ in range(3):
        eng.step()
    rep, ms = timed(lambda: check_serve(eng.ecfg, eng._state))
    if not rep.clean():
        raise AssertionError(f"check_serve mid-run: {explain_serve(rep)}")
    st = eng._state
    pk, fr = faults.inject_nan(st.pool_k, seed=2026, pages=pages)
    lines = explain_serve(check_serve(eng.ecfg, dataclasses.replace(
        st, pool_k=pk)))
    del pk
    if "serve: nan_in_kv" not in lines:
        raise AssertionError(f"inject_nan at {fr.index} not named: {lines}")
    st2, fr2 = faults.double_book_page(eng.ecfg, st, seed=2026)
    lines2 = explain_serve(check_serve(eng.ecfg, st2))
    if not any("double_booked" in ln for ln in lines2):
        raise AssertionError(f"double_book_page not named: {lines2}")
    eng.run()
    rep = check_serve(eng.ecfg, eng._state)
    if not rep.clean():
        raise AssertionError(f"check_serve drained: {explain_serve(rep)}")
    launches.update(tick_launches(eng))
    say(card, f"check_serve at full width: clean after 3 ticks ({ms:.3f} "
              f"ms, NaN scan of {2 * st.pool_k[:, :, :pages].numel() * 2} B "
              f"of pools included) and drained; inject_nan at {fr.index} -> "
              f"nan_in_kv; double_book_page slot {fr2.index[0]} entry "
              f"{fr2.index[1]} -> {[ln for ln in lines2 if 'double' in ln]}")
    del eng, st, st2
    gc.collect()
    torch.cuda.empty_cache()

    ccfg = dataclasses.replace(cfg, num_layers=min(CKPT_LAYERS,
                                                   cfg.num_layers))
    cmodel = lm.init_params(ccfg, seed=0, device=dev)

    def run(eng):
        for p in prompts:
            eng.submit(p, max_new=SERVE_MAX_NEW)
        return eng

    ref = run(build_tick(ccfg, cmodel, dev)[0])
    ref.run()
    gold = {r: q.generated for r, q in ref.finished.items()}
    launches.update(tick_launches(ref))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    eng = run(build_tick(ccfg, cmodel, dev)[0])
    ck = CheckpointedEngine(eng, CKPT_DIR, every=CKPT_EVERY, keep_last=1)
    t0 = time.perf_counter()
    for _ in range(CKPT_EVERY):
        ck.step()
    save_s = time.perf_counter() - t0
    eng.step()
    t0 = time.perf_counter()
    save_engine(eng, CKPT_DIR, CKPT_EVERY + 1, commit=False)
    crash_s = time.perf_counter() - t0
    launches.update(tick_launches(eng))
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in manager.flatten(eng._state))
    del eng
    if manager.latest_step(CKPT_DIR) != CKPT_EVERY:
        raise AssertionError("the uncommitted save counts as a checkpoint")
    eng2, _, _ = build_tick(ccfg, cmodel, dev)
    ptrs = [t.data_ptr() for _, t in manager.flatten(eng2._state)]
    sync(dev)
    t0 = time.perf_counter()
    step = restore_engine(eng2, CKPT_DIR)
    sync(dev)
    restore_s = time.perf_counter() - t0
    if step != CKPT_EVERY or ptrs != [t.data_ptr() for _, t in
                                     manager.flatten(eng2._state)]:
        raise AssertionError(f"restored step {step}, or the state moved")
    eng2.run()
    got = {r: q.generated for r, q in eng2.finished.items()}
    if got != gold or eng2.stats != ref.stats or not check_serve(
            eng2.ecfg, eng2._state).clean():
        bad = [r for r in gold if got.get(r) != gold[r]]
        raise AssertionError(f"restored run differs: requests {bad}, stats "
                             f"{eng2.stats} vs {ref.stats}")
    launches.update(tick_launches(eng2))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    full = nbytes + 2 * (cfg.num_layers - ccfg.num_layers) * cfg.num_kv_heads \
        * (pages + 1) * e["page"] * cfg.hd * 2
    say(card, f"crash mid-tick ({ccfg.name} at full width, "
              f"{ccfg.num_layers} layers): committed at tick {CKPT_EVERY} in {save_s:.3f} s "
              f"(its {CKPT_EVERY} ticks and the save), tick "
              f"{CKPT_EVERY + 1}'s save ({nbytes} B) written and never "
              f"committed in {crash_s:.3f} s; restored into a fresh engine's "
              f"captured graphs (same buffers) in {restore_s:.3f} s; all "
              f"{len(gold)} requests' tokens and the stats == the "
              f"uninterrupted run")
    say(card, f"checkpoint projection (computed from the config, not "
              f"measured): a {cfg.num_layers}-layer checkpoint would hold "
              f"{full} B")
    for name, c in launches.items():
        results[name]["launches"] = results[name].get("launches", 0) + c
    say(card, f"main path (robust serving tick) launches, each graph's at "
              f"capture x its replays: {dict(launches)}")
    del serve["model"], cmodel, eng2, ref
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the paper-figure sweep (repro_torch/eval) and the showdown harness
# ---------------------------------------------------------------------------

EVAL_OUT = os.path.join(HERE, "chiprun_out", "eval")
#: each figure of the port's FIGURES with the arguments its committed
#: baseline's spec records (None: no committed baseline, the defaults);
#: throughput_shards times shard count 1 alone, not the spec's (1, 2, 4,
#: 8): its torch rows are host-bound (about 45 s a shard count), and its
#: comparable records, the hit ratios at shards 1 and 4, are made whatever
#: counts are timed
EVAL_RUNS = (
    ("hit_ratio", "quick.json", {"backends": ("torch", "cuda")}),
    ("sampled_vs_limited", None, {}),
    ("admission", None, {}),
    ("throughput", "BENCH_throughput_fused_quick.json",
     {"backends": ("torch", "cuda"), "shards": (1,)}),
    ("throughput_resident", "BENCH_throughput_resident_quick.json",
     {"backends": ("torch", "cuda")}),
    ("throughput_shards", "BENCH_throughput_vs_shards_quick.json",
     {"shards": (1,)}),
    ("showdown", "BENCH_showdown_quick.json", {}),
    ("synthetic_mix", None, {}),
    ("serving", None, {}),
    ("serving_engine", "BENCH_serving_engine_quick.json", {}),
    ("robustness", "BENCH_robustness_quick.json", {"ttl": True}),
    ("hierarchy", "BENCH_throughput_hierarchy_quick.json", {}),
)
#: the timing figures whose rows are printed beside the card
EVAL_TIMED = ("throughput", "throughput_resident", "throughput_shards",
              "showdown")
#: comparable records a machine without ``cachetools`` cannot reproduce
CACHETOOLS_HR = tuple(f"showdown-hr/{f}/{p}/cachetools"
                      for f in ("zipf", "oltp_mix", "lirs_two_pools")
                      for p in ("lru", "lfu"))


def eval_expected(records) -> tuple:
    """(torch shape groups, cuda points) of a hit-ratio figure's records:
    the captures and kernel-3 launches its run must show."""
    groups = {(r["num_sets"], r["ways"], r["sample"], r["n"], r["admission"])
              for r in records if r["backend"] == "torch"}
    points = sum(len(r["seeds"]) for r in records if r["backend"] == "cuda")
    return len(groups), points


def eval_run(card, name, kw, results, quick=True):
    """Run one figure on the card with the launch and capture counters set
    to 0 just before; check one capture per torch shape group and one
    kernel-3 launch per cuda point; add the launches to the kernels'
    counts.  -> (artifact, seconds)."""
    from repro_torch.eval import artifacts, figures, runner

    fn, figure = figures.FIGURES[name]
    reset_launch_counts()
    runner.reset_capture_counts()
    t0 = time.perf_counter()
    spec, records, skipped = fn(quick=quick, device="cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    captures = runner.capture_counts()
    art = artifacts.make_artifact(figure, spec, records, skipped,
                                  device="cuda")
    tag = "" if quick else "_full"
    artifacts.write_artifact(os.path.join(EVAL_OUT, f"BENCH_{figure}{tag}"
                                          ".json"), art)
    if "assoc" in spec:
        groups, points = eval_expected(records)
        k3 = counts["replay_resident"] + counts["replay_resident_tinylfu"]
        if sum(captures.values()) != groups or any(
                v != 1 for v in captures.values()):
            raise AssertionError(f"{name}: {captures} captures for {groups} "
                                 f"torch shape groups")
        if k3 != points:
            raise AssertionError(f"{name}: {k3} kernel-3 launches for "
                                 f"{points} cuda sweep points")
    for k, c in counts.items():
        results[k]["launches"] = results[k].get("launches", 0) + c
        results[k]["eval_launches"] = results[k].get("eval_launches", 0) + c
    say(card, f"eval {figure}{' (full)' if not quick else ''}: "
              f"{time.perf_counter() - t0:.1f} s wall, {len(records)} "
              f"records, {len(skipped)} skipped; CUDA-graph captures "
              f"{sum(captures.values())} over "
              f"{len(captures)} torch shape groups; launches {counts}")
    if name in EVAL_TIMED:
        for r in records:
            if "p50_req_s" in r or r["metric"] == "req_per_s":
                say(card, f"eval {figure} {r['id']}: {r['metric']} "
                          f"{r['value']} p50_req_s "
                          f"{r.get('p50_req_s', r['value'])} p90_req_s "
                          f"{r.get('p90_req_s')}")
    return art, secs


def eval_step_ms(card, dev):
    """ms per request of a torch sweep group (the quick grid's k8 group: 4
    families x 3 policies, 128 x 8), eager on the card against its CUDA
    graph replayed once per request (the whole ``_replay_group_torch``
    call, capture included, over 6000 requests), without and with
    TinyLFU."""
    from repro_torch.core import admission, hashing, traces
    from repro_torch.eval import runner

    fams = ("zipf", "zipf_shift", "scan_loop", "oltp_mix")
    trs = np.stack([traces.generate(f, 6000, seed=42) for f in fams
                    for _ in range(3)])
    tc = hashing.key_tensor(trs, dev)
    pidx = torch.tensor([0, 1, 4] * 4, dtype=torch.int32, device=dev)
    out = {}
    for label, tl in (("flat", None), ("tinylfu",
                                       admission.for_capacity(1024))):
        g = runner._Group(128, 8, 0, runner.HASH_SEED, tl, pidx, tc)
        for _ in range(20):
            g.step()
        steps = 300
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            g.step()
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner._replay_group_torch(128, 8, 0, runner.HASH_SEED, tl, pidx, tc)
        torch.cuda.synchronize()
        graph = (time.perf_counter() - t0) * 1e3 / tc.shape[1]
        out[label] = (eager, graph)
        say(card, f"eval torch group step ({label}, C=12, 128x8): eager "
                  f"{eager:.4f} ms, CUDA graph {graph:.4f} ms per request "
                  f"({eager / graph:.1f}x)")
    return out


def phase_eval(card, dev, results):
    """Every figure of the port's FIGURES at quick size on the card, each
    gated against its committed baseline (quick.json exactly, all 96
    records; the seven BENCH_*_quick.json within each record's tol, the 6
    cachetools records named as not reproducible here); then the full-size
    hit-ratio figure (5 families x 3 seeds x 60000 requests), its cuda
    records equal to its torch records."""
    from repro_torch.eval import artifacts
    from repro_torch.showdown import HAVE_CACHETOOLS

    eval_step_ms(card, dev)
    seconds = {}
    for name, baseline, kw in EVAL_RUNS:
        art, seconds[name] = eval_run(card, name, kw, results)
        if baseline is None:
            continue
        base = artifacts.load_artifact(os.path.join(BASELINES, baseline))
        cmp = [r for r in base["records"] if r.get("comparable")]
        exact = baseline == "quick.json"
        breaches = artifacts.compare_to_baseline(
            art, base, **({"tol": 0.0} if exact else {}))
        if exact:
            got = {r["id"]: r["value"] for r in art["records"]}
            differ = [r["id"] for r in cmp
                      if got.get(artifacts.port_id(r["id"])) != r["value"]]
            if len(cmp) != 96 or differ or breaches:
                raise AssertionError(f"quick.json: {len(cmp)} records, "
                                     f"differing {differ}, {breaches}")
        excused = []
        if name == "showdown" and not HAVE_CACHETOOLS:
            excused = [f"{rid}: present in baseline, missing from run"
                       for rid in CACHETOOLS_HR]
            if sorted(b for b in breaches if b in excused) != sorted(excused):
                raise AssertionError(f"showdown breaches {breaches}")
        left = [b for b in breaches if b not in excused]
        if left:
            raise AssertionError(f"{baseline}: {len(left)} breaches: {left}")
        say(card, f"eval {baseline}: {len(cmp) - len(excused)}/{len(cmp)} "
                  f"comparable records reproduced"
                  f"{' exactly (delta 0.0)' if exact else ' within tol'}"
                  + (f"; not reproducible without cachetools: "
                     f"{len(excused)} ({', '.join(CACHETOOLS_HR)})"
                     if excused else ""))

    art, seconds["hit_ratio_full"] = eval_run(
        card, "hit_ratio", {"backends": ("torch", "cuda")}, results,
        quick=False)
    by = {r["id"]: r for r in art["records"]}
    cuda = [r for r in art["records"] if r["backend"] == "cuda"]
    differ = [r["id"] for r in cuda
              if r["per_seed"] != by[r["id"].replace("/cuda/", "/torch/")][
                  "per_seed"]]
    spec = art["spec"]
    if len(cuda) != 45 or differ or spec["n"] != 60_000 or len(
            spec["families"]) != 5 or list(spec["seeds"]) != [42, 43, 44]:
        raise AssertionError(f"full-size hit ratio: {len(cuda)} cuda "
                             f"records, differing from torch: {differ}")
    say(card, f"eval hit_ratio_vs_associativity (full: 5 families, seeds "
              f"42-44, n 60000, capacity 1024): {len(cuda)}/45 cuda records "
              f"equal to their torch records, every seed")
    say(card, "eval seconds per figure: " + json.dumps(
        {k: round(v, 2) for k, v in seconds.items()}))


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
    # the kernels build while the set-up and training run (training
    # launches none of them)
    builder = concurrent.futures.ThreadPoolExecutor(1)
    build = builder.submit(phase_build, card)

    state_bytes = NUM_SETS * WAYS * 4
    say(card, f"full-size config: capacity {NUM_SETS * WAYS} entries = "
              f"{NUM_SETS} sets x {WAYS} ways")
    say(card, f"full-size config: state {5 * state_bytes} B in 5 int32 lanes "
              f"+ {state_bytes} B expiry lane")
    say(card, f"full-size config: trace traces.generate({TRACE['family']!r}, "
              f"{TRACE['n']}, seed={TRACE['seed']}, catalog={TRACE['catalog']},"
              f" alpha={TRACE['alpha']}), batch {BATCH} = "
              f"{TRACE['n'] // BATCH} chunks, policies {MAIN_POLICIES}")
    tl_configs = {}
    for policy, tl, label in tl_runs():
        tl_configs.setdefault(label, (tl, []))[1].append(policy.name)
    for label, (tl, names) in tl_configs.items():
        say(card, f"full-size config: TinyLFU {label}: width {tl.width}, "
                  f"door_bits {tl.door_bits}, sample {tl.sample}, sketch "
                  f"{tl.nbytes()} B; policies {names}")
    l1_bytes = HIER_L1_SETS * HIER_L1_WAYS * 4
    say(card, f"full-size config: hierarchy L1 {HIER_L1_SETS} sets x "
              f"{HIER_L1_WAYS} ways ({HIER_L1_SETS * HIER_L1_WAYS} entries, "
              f"{l1_bytes} B per lane, {6 * l1_bytes} B with the expiry "
              f"lane) over the full-size L2 ({6 * state_bytes} B), promote "
              f"and demote on, policies {HIER_POLICIES}; TTL run L1 "
              f"{HIER_TTL_L1_SETS}x{HIER_L1_WAYS} over L2 {TTL_SETS}x{WAYS}, "
              f"ttl_churn {HIER_TTL_N} requests")
    say_serve_config(card)
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
        "replay_resident_tinylfu": dict(
            source="src/repro_torch/kernels/csrc/replay.cu",
            replaces="src/repro/kernels/replay.py:190"),
        "replay_hierarchical": dict(
            source="src/repro_torch/kernels/csrc/replay_hier.cu",
            replaces="src/repro/kernels/replay.py:916"),
        "paged_attention": dict(
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:103",
            exact="within tolerance"),
    }
    serve, train_out, mesh_out = {}, {}, {}
    t0 = time.perf_counter()
    phase_train(card, dev, train_out)
    say(card, f"phase_train done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    build.result()
    builder.shutdown()
    say(card, f"waited {time.perf_counter() - t0:.1f} s more for the build")
    for phase, args in (
            (phase_probe_kernels, (trace, dev, results)),
            (phase_replay_kernel, (trace, ttl_trace, dev, results)),
            (phase_skew_kernel, (trace, dev, results)),
            (phase_tinylfu_kernel, (trace, dev, results)),
            (phase_hier_kernel, (trace, ttl_trace, dev, results)),
            (phase_quick_records, (dev,)),
            (phase_slice_records, (dev,)),
            (phase_main_path, (trace, ttl_trace, dev, results)),
            (phase_main_path_tinylfu, (trace, dev, results)),
            (phase_main_path_hier, (trace, ttl_trace, dev, results)),
            (phase_timing, (trace, dev, results)),
            (phase_serve_agreement, (dev,)),
            (phase_serve_path, (dev, results, serve)),
            (phase_serve_tick, (dev, results, serve)),
            (phase_sharded_replay, (trace, ttl_trace, dev, results)),
            (phase_sharded_serve, (dev, results, serve)),
            (phase_robust, (trace, ttl_trace, dev, results)),
            (phase_robust_serve, (dev, results, serve)),
            (phase_paged_attention_kernel, (dev, results, serve)),
            (phase_paged_attention_timing, (dev, results, serve)),
            (phase_families, (dev, results, serve)),
            (phase_mesh_dryrun, (trace, dev, results, mesh_out)),
            (phase_eval, (dev, results))):
        t0 = time.perf_counter()
        phase(card, *args)
        say(card, f"{phase.__name__} done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "exact": r.get("exact", r["max_abs_err"] == 0),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r.get("library_ms"),
            **{k: v for k, v in r.items()
               if k in ("requests", "tol", "host_ms", "bound_share", "split",
                        "form", "blocks", "requests_per_s", "bucket_share",
                        "split_us", "scale_ms", "scale_device_ms",
                        "scale_phases")
               or k.startswith(("full_", "serve_", "gqa_", "max_abs_err_",
                                "eval_", "families_",
                                "layer0_", "global_", "bucket_", "skew_",
                                "narrow_", "ops_", "sharded_"))}})
    print("kernels " + ", ".join(
        f"{k['name']}: launches={k['launches']} exact={k['exact']} "
        f"ms={k['ms']:.4f}" for k in kernels) + f" [{card}]")
    say(card, f"cards on this machine: {torch.cuda.device_count()}; the "
              f"script drives card 0")
    say(card, f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train": train_out}))
    print(json.dumps({"mesh": mesh_out}, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    # the script drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
