"""Kernels 1-5, the chunked path and the serving path of one source tree,
on one GPU.

    python3 chip_ab.py [SRC] [--label NAME] [--sections probe,k3,k4,serve]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``),
builds its kernels and, at chip_smoke.py's full-size configurations and
with its timing helpers (``time_replay_trace``, ``time_hier_trace``,
``drive_engine``, ``time_paged_attention``), so that both scripts time
alike:

  0. (``probe``) kernels 1 and 2 at the ops level, as the ``cuda`` backend
     calls them (``ops.probe_orders`` and ``ops.fused_probe`` on the
     131072 x 8 LRU state filled by the trace's first 2^20 requests, 1024
     queries): CUDA events per call, the host's time per call and the
     device time of all the call's device work (torch.profiler);
     ``ops.fused_probe`` again on a 2^24-entry state (2^21 x 8), where a
     copy of ``meta_a`` would cost 16x more; and the requests/s of the
     chunked path (``CudaBackend.replay_scan``, LRU, 131072 x 8, B = 1024,
     the trace's first 2^20 requests; the median of three runs);
  1. replays the whole 2^22-request zipf trace through the 131072 x 8
     cache with kernel 3, flat LRU and TinyLFU (``for_capacity(2^20)``):
     CUDA events per wrapper call (mean of 3 after a warm-up), and the
     device time of its kernels by torch.profiler;
  2. replays the whole 2^22-request zipf trace through the L1-over-L2
     hierarchy (LRU, L1 512 x 16 over the 131072 x 8 L2) with kernel 4:
     CUDA events around one launch, and its device time by torch.profiler;
  3. serves chip_smoke.py's traffic at deepseek-7b's full width through
     ``Engine.run`` on the ``cuda`` backend: one warm-up run, then
     ``--runs`` timed runs (tokens/s by the host clock), the first of them
     capturing every layer's kernel-5 inputs of one decode step, then
     times kernel 5 round-robin over those layers: CUDA events per call,
     the wrapper's host time per call, the device time by torch.profiler.

It prints the card's name and power limit, then one JSON line.  To compare
two trees, unpack the other into a gitignored directory (``git archive``)
and run this script on each in turns on one card, on one machine (A, B,
B, A): a machine's host speed, and so tokens/s, varies between machines.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SECTIONS = ("probe", "k3", "k4", "serve")
#: the 2^24-entry state on which kernel 2 is timed again
BIG_SETS = 2**21
#: requests of the trace the chunked path replays
CHUNKED_N = 2**20


def probe_section(cs, out, trace, dev):
    """Section 0: kernels 1 and 2 at the ops level, kernel 2 on a
    2^24-entry state, the chunked path's requests/s."""
    from repro_torch.core import hashing, router
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import ops

    prefix = router.pad_chunks(trace[:cs.PREFIX], cs.BATCH)
    q = hashing.key_tensor(trace[cs.PREFIX:cs.PREFIX + cs.BATCH], dev)
    en = torch.ones(cs.BATCH, dtype=torch.bool, device=dev)
    for sets, tag in ((cs.NUM_SETS, ""), (BIG_SETS, "_2e24")):
        cfg = KWayConfig(num_sets=sets, ways=cs.WAYS, policy=Policy.LRU)
        st = cs.fill_state(cfg, prefix, dev)
        out[f"fused_ops_ms{tag}"] = cs.cuda_ms(
            lambda: ops.fused_probe(cfg, st, q, en), 200)
        out[f"fused_ops_host_us{tag}"] = cs.host_us(
            lambda: ops.fused_probe(cfg, st, q, en))
        # all device activity of one ops call (the previous design's route
        # kernels and copy of meta_a included)
        out[f"fused_ops_device_ms{tag}"] = cs.profiled_device_ms(
            lambda: ops.fused_probe(cfg, st, q, en), 20, ("",))
        if tag:
            break
        out["orders_ops_ms"] = cs.cuda_ms(
            lambda: ops.probe_orders(cfg, st, q), 200)
        out["orders_ops_host_us"] = cs.host_us(
            lambda: ops.probe_orders(cfg, st, q))
        out["orders_ops_device_ms"] = cs.profiled_device_ms(
            lambda: ops.probe_orders(cfg, st, q), 20, ("",))
        del st
    del st
    torch.cuda.empty_cache()

    cfg = KWayConfig(num_sets=cs.NUM_SETS, ways=cs.WAYS, policy=Policy.LRU)
    be = make_backend("cuda", cfg, dev)
    chunks, cen = router.pad_chunks(trace[:CHUNKED_N], cs.BATCH)
    be.replay_scan(be.init(), chunks[:8], cen[:8])
    # host-bound, so it varies: three runs, the median reported
    runs = [cs.timed(lambda: be.replay_scan(be.init(), chunks, cen))
            for _ in range(3)]
    (hits, evs, _, _), _ = runs[0]
    all_ms = [ms for _, ms in runs]
    ms = sorted(all_ms)[1]
    out.update(chunked_ms=ms, chunked_runs_ms=all_ms,
               chunked_requests_per_s=CHUNKED_N / ms * 1e3,
               chunked_hits=int(hits.sum()), chunked_evictions=int(evs.sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"sections must be among {SECTIONS}")
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke as cs
    from repro_torch.core import admission, hashing, hierarchy, kway, router
    from repro_torch.core import traces
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models import lm

    dev = torch.device("cuda")
    print(cs.card_line())
    out = {"label": args.label, "src": args.src}
    t0 = time.perf_counter()
    _build.build_all()
    out["build_s"] = time.perf_counter() - t0

    trace = traces.generate(cs.TRACE["family"], cs.TRACE["n"],
                            seed=cs.TRACE["seed"], catalog=cs.TRACE["catalog"],
                            alpha=cs.TRACE["alpha"])
    if "probe" in sections:
        probe_section(cs, out, trace, dev)
    chunks, en = router.pad_chunks(trace, cs.BATCH)
    qkeys = hashing.key_tensor(chunks, dev)
    enabled = torch.from_numpy(en).to(dev)
    cfg = KWayConfig(num_sets=cs.NUM_SETS, ways=cs.WAYS, policy=Policy.LRU)
    out["requests"] = len(trace)

    # 1. kernel 3 over the whole trace, flat and TinyLFU
    st0 = kway.make_cache(cfg, device=dev)
    for label, tl in (("flat", None),
                      ("tinylfu", admission.for_capacity(cs.NUM_SETS
                                                         * cs.WAYS))):
        if "k3" not in sections:
            break
        (hits, evs, _, _), ms, dev_ms = cs.time_replay_trace(
            cfg, st0, qkeys, enabled, tinylfu=tl, reps=3)
        out.update({f"k3_{label}_ms": ms, f"k3_{label}_device_ms": dev_ms,
                    f"k3_{label}_hits": int(hits.sum()),
                    f"k3_{label}_evictions": int(evs.sum())})

    # 2. kernel 4 over the whole trace
    if "k4" in sections:
        hc = hierarchy.HierarchyConfig(l1_sets=cs.HIER_L1_SETS,
                                       l1_ways=cs.HIER_L1_WAYS)
        hst = hierarchy.make_hier(cfg, hc, device=dev)
        (hits, _, _, _), ms, dev_ms = cs.time_hier_trace(cfg, hc, hst, qkeys,
                                                         enabled)
        out.update(hier_ms=ms, hier_device_ms=dev_ms,
                   hier_hits=int(hits.sum()))
        del hst
    del qkeys, enabled, st0
    if "serve" not in sections:
        print(json.dumps(out))
        return 0

    # 3. serving at full width
    scfg = cs.serve_config()
    model = lm.init_params(scfg, seed=0, device=dev)
    prompts = cs.serve_traffic(scfg.vocab_size)
    cs.drive_engine(scfg, model, "cuda", prompts, dev)
    tok_s, inputs, stats = [], None, None
    for k in range(args.runs):
        if k == 0:
            with cs.CaptureStep(scfg.num_layers,
                                cs.SERVE_CAPTURE_STEP) as cap:
                stats, reqs, wall, hr = cs.drive_engine(scfg, model, "cuda",
                                                        prompts, dev)
            inputs = cap.inputs
        else:
            stats, reqs, wall, hr = cs.drive_engine(scfg, model, "cuda",
                                                    prompts, dev)
        tok_s.append(sum(len(t) for t, _, _ in reqs.values()) / wall)
    out.update(serve_tokens_per_s=tok_s, serve_hit_ratio=hr,
               serve_stats=stats)
    del model
    torch.cuda.empty_cache()

    # kernel 5 round-robin over the captured layers
    runs = [lambda a=a: kpa.paged_attention(*a[:5], **a[5]) for a in inputs]
    out["pa_ms"], out["pa_host_ms"], out["pa_device_ms"] = \
        cs.time_paged_attention(runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
