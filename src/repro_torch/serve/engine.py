"""Continuous-batching serving engine with a k-way set-associative prefix
cache: the paper's cache as the page-residency manager of a paged KV cache.

Counterpart of ``repro/serve/engine.py``.  The page pool is split into

  * a **shared region** of exactly ``num_sets x ways`` pages, owned 1:1 by
    the k-way cache slots (cache value == page id).  A full prompt block
    (``page`` tokens), keyed by its prefix-chain hash, lives there at most
    once; the eviction policy (and optional TinyLFU admission) decides
    residency, and evicting a key frees its page;
  * a **private region** for tail and decode pages (a partial block is not
    content-addressable until it is full).

Two execution modes share one set of semantics, as in the reference:

  * ``jitted=False``, the host loop: Python bookkeeping per request, one
    call per model op.  Each admitted prompt runs one fixed-width prefix
    transaction over ``max_prompt // page`` block lanes (TinyLFU record ->
    peek_victims -> admit, then get and a slot-returning put), one padded
    prefill, and writes its K/V from the first chain miss on; each step
    then runs ``decode_block`` batched paged decode steps.  The
    differential oracle.
  * ``jitted=True``, the device-resident tick: one serving tick (admit
    waiting requests into free slots -> the prefix-chain transaction as one
    fused slot-returning ``access`` per lane -> page allocation -> tiled
    batched prefill -> a burst of ``decode_block`` paged decodes with
    sampling and retirement) is one function, ``_tick``, over a fixed
    ``[max_batch]`` slot array (``ServeState``) whose tensors stay at fixed
    addresses for the engine's life.  On the card the engine captures it
    as CUDA graphs (an *admit* graph, phases 1-4, and a *decode* graph,
    phase 4 alone) and replays one graph per tick; the emitted tokens land
    in pinned host memory inside the graph, and ``_fetch`` is the tick's
    one host sync.  With ``device="cpu"`` the same body runs eagerly.

Both modes give the same tokens, hit ratios and eviction counts.  The
prefix cache runs on any of the port's backends (``torch``, ``cuda``,
``ref``); the tick needs a traceable one (``torch`` or ``cuda``) and an
unsharded cache.  On the card the tick runs kernel 2 (one fused probe per
admission lane), kernel 1 (``peek_victims`` under TinyLFU) and kernel 5
(every layer of every decode step) inside the graphs.  With ``shards > 1``
the host loop's prefix cache is a ``core/sharded.py`` ``ShardedCache``
(global slot ids, routing on the device); the tick refuses it, as the
reference does.

The engine serves every decoder-only config with attention (dense, MoE,
hybrid), as the reference's does.  Decode tokens are greedy at
``temperature <= 0``; otherwise each step draws the reference's own
``jax.random.categorical`` sample (``core/prng.py``: the same threefry
words, keyed on ``sample_seed`` and the ``decode_steps`` counter, which the
tick reads on the device), so both modes sample the reference's tokens.
The prefill's first token is always the argmax.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import admission
from repro_torch.core.backend import make_backend, resolve_device
from repro_torch.core import hashing
from repro_torch.core.hashing import key_tensor, prefix_block_hashes
from repro_torch.core.kway import KWayConfig, KWayState
from repro_torch.core.policies import Policy
from repro_torch.core import prng
from repro_torch.kernels import kway_probe as kprobe
from repro_torch.kernels import paged_attention as kpa
from repro_torch.models import lm
from repro_torch.robust import events
from repro_torch.robust.watchdog import watch
from repro_torch.serve import paged_model as pm

UNSHARDED = ("jitted engine requires an unsharded prefix cache (shards == "
             "1); the sharded path is host-loop only")

#: The tick's graph kinds: ``admit`` runs phases 1-4, ``decode`` phase 4
#: alone (nothing to admit, or no free slot).
KINDS = ("admit", "decode")
#: The stat counters of ``ServeState.counters``, in order.
COUNTERS = ("prefix_hits", "prefix_lookups", "evictions", "prefills",
            "decode_steps")

#: CUDA-graph captures of the device-resident tick, keyed by (model,
#: engine config, graph kind), counted where a graph is captured (on the
#: CPU nothing is captured: the body runs eagerly).  A CUDA graph holds the
#: addresses of its engine's buffers, so each engine captures its own:
#: the economy contract is one capture per kind per engine, however many
#: ticks it runs.
_CAPTURES: Counter = Counter()


def capture_counts() -> dict:
    """Snapshot of the tick's captures per (model, engine config, kind)."""
    return dict(_CAPTURES)


def reset_capture_counts() -> None:
    _CAPTURES.clear()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1                    # batch slot when running
    pos: int = 0                      # tokens materialized so far
    pages: list = dataclasses.field(default_factory=list)   # page ids in order
    private: list = dataclasses.field(default_factory=list)  # owned pages
    done: bool = False
    prefix_hits: int = 0
    prefix_lookups: int = 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    page: int = 16
    num_sets: int = 64                # shared region = num_sets x ways pages
    ways: int = 8
    policy: Policy = Policy.LRU
    tinylfu: bool = False
    max_batch: int = 8                # request slots
    max_seq: int = 512
    private_pages: int = 256
    backend: str = "torch"            # cache backend: "torch" | "cuda" | "ref"
    # > 1: the prefix cache's set axis splits across shards, routed on the
    # device (core/sharded.py); host loop only
    shards: int = 1
    # True: run each engine step as one device-resident tick (ServeState +
    # _tick), captured as CUDA graphs on the card: one graph launch and one
    # host sync per tick.  Needs a traceable backend ("torch"/"cuda") and
    # shards == 1; the host loop (jitted=False) is the differential oracle.
    jitted: bool = False
    # Static prompt-width ceiling for the fixed-width prefix transaction and
    # the padded prefill (0: max_seq).  Must be a multiple of ``page``;
    # longer prompts are rejected at submit().
    max_prompt: int = 0
    # 0: greedy decode (argmax).  > 0: softmax sampling at this temperature,
    # seeded from (sample_seed, decode_step) identically in both modes.  The
    # prefill's first token is always argmax.
    temperature: float = 0.0
    sample_seed: int = 0
    # Decode steps per engine step (multi-step scheduling): admit, then
    # ``decode_block`` decodes; page allocation order, and so out-of-page
    # retirement, follows this schedule.  The tick runs the whole burst
    # (one graph launch and one host sync per ``decode_block`` tokens).
    decode_block: int = 1
    # > 0: watchdog over the tick's one host sync: each expired wait of
    # ``sync_timeout_s`` (growing by ``sync_backoff``) records a
    # degradation event; after ``sync_retries`` extra waits the tick raises
    # WatchdogTimeout instead of hanging.  0 disables (a plain wait).
    sync_timeout_s: float = 0.0
    sync_retries: int = 2
    sync_backoff: float = 2.0


def _launch_counts() -> Counter:
    """The kernel wrappers' launch counters, by wrapper."""
    return Counter({**kprobe.LAUNCHES, **kpa.LAUNCHES})


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token: argmax, ties to the first index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sample_next(ecfg: EngineConfig, logits: torch.Tensor,
                 decode_step) -> torch.Tensor:
    """Next decode token, shared by both modes: the argmax at
    ``temperature <= 0``, else the reference's ``categorical(fold_in(
    PRNGKey(sample_seed), decode_step), logits / temperature)``.
    ``decode_step`` is an int (the host loop's counter) or a 0-d device
    tensor (the tick's), read with no host sync."""
    if ecfg.temperature <= 0.0:
        return _argmax(logits)
    key = prng.fold_in(prng.prng_key(ecfg.sample_seed), decode_step,
                       device=logits.device)
    # a tensor divisor: IEEE division by float32(temperature) on any device
    # (a Python scalar may become a product by its reciprocal)
    scaled = logits.float() / torch.full_like(logits, ecfg.temperature,
                                              dtype=torch.float32)
    return prng.categorical(key, scaled).to(torch.int32)


# ---------------------------------------------------------------------------
# the device-resident serving tick
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeState:
    """The tick's carry, at fixed addresses for the engine's life: the
    static buffers that the captured graphs read and write.

    Slot lanes are indexed by the fixed ``[max_batch]`` request-slot array;
    ``owner`` maps each private page to its owning slot (-1: free).  The
    pools carry one *sink* page past the last real one (``write_pages_sink``),
    which no page table names."""

    kstate: KWayState
    sketch: Optional[admission.TinyLFUState]
    pool_k: torch.Tensor    # bf16 [L, KVH, P + 1, page, D]; page P: the sink
    pool_v: torch.Tensor
    owner: torch.Tensor     # int32 [private_pages] owning slot | -1
    active: torch.Tensor    # bool  [S]
    rid: torch.Tensor       # int32 [S]
    pos: torch.Tensor       # int32 [S] tokens materialized
    n_gen: torch.Tensor     # int32 [S] tokens emitted (prefill token included)
    max_new: torch.Tensor   # int32 [S]
    last_tok: torch.Tensor  # int32 [S]
    n_pages: torch.Tensor   # int32 [S]
    page_tbl: torch.Tensor  # int32 [S, PPS]
    counters: torch.Tensor  # int32 [len(COUNTERS)]


def _select(do: torch.Tensor, new, old):
    """``lax.cond(do, run, skip)`` on a dataclass of tensors: ``new``'s
    lanes where ``do``, else ``old``'s, bit for bit (None stays None)."""
    return dataclasses.replace(old, **{
        f.name: torch.where(do, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old) if getattr(old, f.name) is not None})


def _copy_into(dst, src) -> None:
    """Copy each tensor field of dataclass ``src`` into ``dst``'s, in place
    (a field that is the same object in both is left as it is)."""
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if d is not None and getattr(src, f.name) is not d:
            d.copy_(getattr(src, f.name))


def _emitted_sizes(ecfg: EngineConfig) -> tuple:
    """(name, words) of the emitted int32 vector, in order."""
    s, n = ecfg.max_batch, ecfg.decode_block
    return (("admitted", s), ("pre_tok", s), ("pre_hits", s),
            ("pre_lookups", s), ("rid", s), ("dec_mask", n * s),
            ("dec_tok", n * s), ("retired", n * s), ("n_active", 1),
            ("clash", 1))


def _admit_lanes(ecfg, backend, sketch_cfg, st, keys_all, n_full, tail,
                 avail, order, n_free):
    """Phase 1: the admission transactions, lane by lane.  Waiting lane j
    goes to the j-th free slot; a refused lane blocks the rest.  A lane
    that does not run (the reference's ``lax.cond`` skip) leaves the cache,
    clock included, the sketch and ``owner`` as they were.
    -> (kstate', sketch', owner', per-lane [S] admitted, hits, lookups,
    tails, evictions, tail pages, and pages [S, pbw])."""
    dev = keys_all.device
    i32 = torch.int32
    pbw = keys_all.shape[1]
    n_priv = ecfg.private_pages
    shared = backend.cfg.capacity
    blk = torch.arange(pbw, device=dev)
    priv = torch.arange(n_priv, device=dev)
    zero_vals = torch.zeros(pbw, dtype=i32, device=dev)
    kstate, sketch, owner = st.kstate, st.sketch, st.owner
    blocked = torch.zeros((), dtype=torch.bool, device=dev)
    ys = []
    for j in range(ecfg.max_batch):
        do = avail[j] & (n_free > j) & ~blocked
        keys = keys_all[j]
        validb = blk < n_full[j]
        # the fixed-width prefix-chain transaction, in the host loop's order
        admit_mask, sk = None, sketch
        if sketch_cfg is not None:
            sk = admission.record(sketch_cfg, sketch, keys, enabled=validb)
            vk, vv = backend.peek_victims(kstate, keys)
            admit_mask = admission.admit(sketch_cfg, sk, keys, vk, vv)
        ks, hit, pages_blk, _, ev = backend.access(
            kstate, keys, zero_vals, admit_on_miss=admit_mask,
            enabled=validb, slot_value=True)
        n_hit = torch.cumprod(hit.to(i32), 0).sum()
        unlanded = validb & (pages_blk < 0)
        n_unl = unlanded.sum()
        ok = (owner < 0).sum() >= n_unl + (tail[j] > 0).to(n_unl.dtype) + 2
        # private pages for unlanded blocks + tail, lowest free index first;
        # a refused lane allocates nothing
        free_order = torch.argsort((owner >= 0).to(i32), stable=True)
        rank = torch.cumsum(unlanded.to(torch.int64), 0) - 1
        blk_idx = free_order[rank.clamp(0, n_priv - 1)]
        pages2 = torch.where(unlanded, shared + blk_idx, pages_blk.long())
        # (a 0-d index tensor would be read on the host: gather instead)
        tail_idx = free_order.gather(
            0, n_unl.clamp(0, n_priv - 1).reshape(1)).reshape(())
        taken = (((blk_idx[:, None] == priv[None, :])
                  & unlanded[:, None]).any(0)
                 | ((priv == tail_idx) & (tail[j] > 0))) & ok
        own = torch.where(taken, order[j].to(i32), owner)
        kstate = _select(do, ks, kstate)
        if sketch is not None:
            sketch = _select(do, sk, sketch)
        owner = torch.where(do, own, owner)
        blocked = blocked | (do & ~ok)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ys.append((do & ok,) + tuple(
            torch.where(do, v, zero) for v in (
                n_hit.long(), n_full[j].long(), tail[j].long(),
                ev.sum(), shared + tail_idx)) + (
            torch.where(do, pages2, zero),))
    cols = [torch.stack(c) for c in zip(*ys)]
    return (kstate, sketch, owner, cols[0],
            *(c.to(i32) for c in cols[1:]))


def _prefill_tiles(cfg, ecfg, model, st, toks, length, admitted, pre_hits,
                   pre_lookups, tail, pages2, tail_page):
    """Phase 3: tiled batched prefill (``min(8, S)`` lanes a tile), the
    K/V of each admitted lane written from its first chain miss on, then
    its tail page (zero-padded).  Lanes not admitted write the sink page.
    -> first token per lane (0 where not admitted)."""
    dev = toks.device
    n_slots, mp = toks.shape
    page = ecfg.page
    pbw = mp // page
    sink = st.pool_k.shape[2] - 1
    tile = min(8, n_slots)
    blk = torch.arange(pbw, device=dev)
    arange_pg = torch.arange(page, device=dev)
    toks0 = []
    for lo in range(0, n_slots, tile):
        sel = slice(lo, min(lo + tile, n_slots))
        adm_t = admitted[sel]
        logits, ks, vs = pm.prefill_padded(cfg, model, toks[sel],
                                           length[sel])
        wmask = ((blk[None, :] < pre_lookups[sel, None])
                 & (blk[None, :] >= pre_hits[sel, None]) & adm_t[:, None])
        pm.write_pages_sink(cfg, (ks, vs), pages2[sel], st.pool_k, st.pool_v,
                            wmask)
        # tail tokens -> one private page per lane
        idx = (pre_lookups[sel, None].long() * page
               + arange_pg[None, :]).clamp(max=mp - 1)
        rows = torch.arange(idx.shape[0], device=dev)[:, None]
        tmask = (arange_pg[None, :] < tail[sel, None])[None, :, :, None, None]
        tgt = torch.where(adm_t & (tail[sel] > 0), tail_page[sel].long(),
                          sink)
        for src, pool in ((ks, st.pool_k), (vs, st.pool_v)):
            kt = torch.where(tmask, src[:, rows, idx], 0)
            pool[:, :, tgt] = kt.movedim(3, 1)
        toks0.append(torch.where(adm_t, _argmax(logits), 0))
    return torch.cat(toks0)


def _decode_burst(cfg, ecfg, model, st, shared, active, pos, n_gen, max_new,
                  last_tok, n_pages, owner, page_tbl, decode_steps):
    """Phase 4: ``decode_block`` steps, each a sequential page allocation
    over slots (an out-of-page retire frees its pages for later slots in
    the same step, as in the host loop), one batched paged decode, greedy
    sampling and retirement.  -> (the slot fields and ``owner``,
    ``page_tbl``, ``decode_steps`` after the burst, and per step the
    decoded mask, tokens, retirements and clash flags)."""
    dev = active.device
    n_slots, page = ecfg.max_batch, ecfg.page
    lanes = torch.arange(n_slots, device=dev)
    priv = torch.arange(ecfg.private_pages, device=dev)
    cols = torch.arange(page_tbl.shape[1], device=dev)
    out = []
    for _ in range(ecfg.decode_block):
        early = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        for i in range(n_slots):
            mine = lanes == i
            needs = active[i] & (pos[i] % page == 0) & \
                (pos[i] // page >= n_pages[i])
            can = needs & (owner < 0).any()
            fidx = torch.argmin((owner >= 0).to(torch.int32))  # first free
            owner = torch.where((priv == fidx) & can, i, owner)
            page_tbl = torch.where(
                mine[:, None] & (cols == pos[i] // page)[None, :] & can,
                (shared + fidx).to(torch.int32), page_tbl)
            n_pages = n_pages + (mine & can).to(torch.int32)
            er = needs & ~can                  # out of pages: retire early
            owner = torch.where(er & (owner == i), -1, owner)
            active = active & ~(mine & er)
            early = early | (mine & er)
        tok = torch.where(active, last_tok, 0)
        posv = torch.where(active, pos, 0)
        logits, clash = pm.decode_paged_sink(cfg, model, tok, posv, st.pool_k,
                                             st.pool_v, page_tbl, active)
        nxt = _sample_next(ecfg, logits, decode_steps)
        pos = torch.where(active, pos + 1, pos)
        n_gen = torch.where(active, n_gen + 1, n_gen)
        last_tok = torch.where(active, nxt, last_tok)
        decode_steps = decode_steps + active.any().to(torch.int32)
        fin = active & ((n_gen >= max_new + 1) | (pos >= ecfg.max_seq - 1))
        owner = torch.where(
            (owner >= 0) & fin[owner.clamp(0, n_slots - 1).long()], -1, owner)
        out.append((active, torch.where(active, nxt, 0), early | fin, clash))
        active = active & ~fin
    return (active, pos, n_gen, last_tok, n_pages, owner, page_tbl,
            decode_steps, [torch.stack(c) for c in zip(*out)])


@torch.no_grad()
def _tick(cfg: ModelConfig, ecfg: EngineConfig, backend, sketch_cfg,
          model: lm.LM, st: ServeState, batch: torch.Tensor,
          admit: bool) -> torch.Tensor:
    """One serving tick on ``st``, in place, in the reference's four phases
    (admission, activation, prefill, decode burst) with its masks.

    ``batch`` int32 [S, max_prompt + 4]: each waiting lane's padded prompt,
    then its length, max_new, request id and availability (0/1).  With
    ``admit`` False phases 1-3 are left out: nothing is admitted, which is
    what the reference's tick computes when no lane is available or no
    slot is free.  The body is fixed-shape with no host sync (no
    ``.item()``, boolean indexing, ``nonzero`` or host array), so a CUDA
    graph can capture it; a skipped branch of the reference's ``lax.cond``
    is a ``torch.where`` that keeps the old value.  Ends by copying every
    new field into ``st``.  -> the emitted int32 vector
    (``_emitted_sizes``)."""
    dev = st.active.device
    i32 = torch.int32
    n_slots, page = ecfg.max_batch, ecfg.page
    mp = batch.shape[1] - 4
    shared = backend.cfg.capacity
    zeros = torch.zeros(n_slots, dtype=i32, device=dev)
    active, rid, pos, n_gen = st.active, st.rid, st.pos, st.n_gen
    max_new, last_tok, n_pages = st.max_new, st.last_tok, st.n_pages
    owner, page_tbl, counters = st.owner, st.page_tbl, st.counters
    admitted = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    pre_tok, pre_hits, pre_lookups = zeros, zeros, zeros
    if admit:
        # ---- phase 1: admission transactions ---------------------------
        toks, length = batch[:, :mp], batch[:, mp]
        order = torch.argsort(active.to(i32), stable=True)
        keys_all = hashing.to_i32(hashing.prefix_block_hashes_t(toks, page))
        n_full = length // page
        tail = length - n_full * page
        (kstate, sketch, owner, admitted, pre_hits, pre_lookups, tail,
         ev_cnt, tail_page, pages2) = _admit_lanes(
            ecfg, backend, sketch_cfg, st, keys_all, n_full, tail,
            batch[:, mp + 3] != 0, order, (~active).sum())
        _copy_into(st.kstate, kstate)
        if sketch is not None:
            _copy_into(st.sketch, sketch)
        counters = counters + torch.stack([
            pre_hits.sum(), pre_lookups.sum(), ev_cnt.sum(),
            admitted.sum(), torch.zeros_like(ev_cnt.sum())]).to(i32)
        # ---- phase 2: lane activation (slot i <- its admitted lane) ----
        to_slot = (order[None, :] == torch.arange(n_slots, device=dev)[:, None]
                   ) & admitted[None, :]
        has = to_slot.any(1)
        src = (to_slot.long() * torch.arange(n_slots, device=dev)).sum(1)

        def put(field, vals):
            return torch.where(has.reshape((-1,) + (1,) * (vals.dim() - 1)),
                               vals[src].to(field.dtype), field)

        pbw = mp // page
        blk = torch.arange(pbw, device=dev)
        rows = torch.where(blk[None, :] < pre_lookups[:, None], pages2, 0)
        rows = torch.cat([rows, torch.zeros(
            (n_slots, page_tbl.shape[1] - pbw), dtype=i32, device=dev)], 1)
        rows = torch.where(
            (torch.arange(rows.shape[1], device=dev)[None, :]
             == pre_lookups[:, None]) & (admitted & (tail > 0))[:, None],
            tail_page[:, None], rows)
        active = active | has
        rid = put(rid, batch[:, mp + 2])
        pos = put(pos, length)
        n_gen = put(n_gen, torch.ones_like(length))
        max_new = put(max_new, batch[:, mp + 1])
        n_pages = put(n_pages, pre_lookups + (tail > 0).to(i32))
        page_tbl = put(page_tbl, rows)
        # ---- phase 3: tiled batched prefill + page writes --------------
        pre_tok = _prefill_tiles(cfg, ecfg, model, st, toks, length,
                                 admitted, pre_hits, pre_lookups, tail,
                                 pages2, tail_page)
        last_tok = put(last_tok, pre_tok)
    # ---- phase 4: decode burst -----------------------------------------
    (active, pos, n_gen, last_tok, n_pages, owner, page_tbl, decode_steps,
     (dec_mask, dec_tok, retired, clash)) = _decode_burst(
        cfg, ecfg, model, st, shared, active, pos, n_gen, max_new, last_tok,
        n_pages, owner, page_tbl, counters[4])
    _copy_into(st, dataclasses.replace(
        st, owner=owner, active=active, rid=rid, pos=pos, n_gen=n_gen,
        max_new=max_new, last_tok=last_tok, n_pages=n_pages,
        page_tbl=page_tbl,
        counters=torch.cat([counters[:4], decode_steps.reshape(1)])))
    return torch.cat([t.reshape(-1).to(i32) for t in (
        admitted, pre_tok, pre_hits, pre_lookups, rid, dec_mask, dec_tok,
        retired, active.sum(), clash.any())])


class Engine:
    """Serving engine: the host loop, or with ``ecfg.jitted`` the
    device-resident tick.  ``model`` is an ``lm.LM`` whose parameters lie
    on ``device`` (None: the card)."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, ecfg: EngineConfig,
                 device=None):
        if not (cfg.has_attention and cfg.enc_layers == 0):
            raise ValueError(
                "paged engine serves decoder-only attention archs; "
                f"got has_attention={cfg.has_attention}, "
                f"enc_layers={cfg.enc_layers} — attention-free archs bypass "
                "it (DESIGN.md §4)")
        if ecfg.max_seq % ecfg.page != 0:
            raise ValueError(
                f"EngineConfig.max_seq ({ecfg.max_seq}) must be a multiple "
                f"of page ({ecfg.page})")
        if ecfg.decode_block < 1:
            raise ValueError(
                f"EngineConfig.decode_block must be >= 1, "
                f"got {ecfg.decode_block}")
        self.max_prompt = ecfg.max_prompt or ecfg.max_seq
        if self.max_prompt % ecfg.page != 0 or \
                self.max_prompt > ecfg.max_seq:
            raise ValueError(
                f"EngineConfig.max_prompt ({self.max_prompt}) must be a "
                f"multiple of page ({ecfg.page}) and <= max_seq "
                f"({ecfg.max_seq})")
        if ecfg.jitted and ecfg.shards > 1:
            raise ValueError(UNSHARDED)
        self.device = resolve_device(device)
        self.kcfg = KWayConfig(num_sets=ecfg.num_sets, ways=ecfg.ways,
                               policy=ecfg.policy)
        if ecfg.shards > 1:
            # ShardedCache keeps the get/put/peek_victims contract with
            # global slot ids
            from repro_torch.core.sharded import ShardedCache, ShardedConfig
            self.backend = ShardedCache(ShardedConfig(
                cache=self.kcfg, num_shards=ecfg.shards,
                backend=ecfg.backend), device=self.device)
        else:
            self.backend = make_backend(ecfg.backend, self.kcfg, self.device)
        if ecfg.jitted and not self.backend.traceable:
            raise ValueError(
                f"jitted engine requires a traceable cache backend; "
                f"{ecfg.backend!r} is host Python — use the host loop "
                "(jitted=False) for the ref oracle")
        if model.device.type != self.device.type:
            raise ValueError(f"model parameters lie on {model.device}, the "
                             f"engine runs on {self.device}")
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self._events_start = events.cursor()
        self.sketch_cfg = (admission.for_capacity(self.kcfg.capacity)
                           if ecfg.tinylfu else None)
        shared = self.kcfg.capacity
        total = shared + ecfg.private_pages
        self.pps = ecfg.max_seq // ecfg.page
        self.pbw = self.max_prompt // ecfg.page
        self.waiting: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        kstate = self.backend.init()
        sketch = (admission.make_sketch(self.sketch_cfg, self.device)
                  if ecfg.tinylfu else None)
        if ecfg.jitted:
            self.running: dict[int, Request] = {}
            #: ticks run, by graph kind (on the card each is a replay)
            self.ticks: Counter = Counter()
            self._init_tick(kstate, sketch, total + 1)
            return
        self.kstate, self.sketch = kstate, sketch
        self._stats = {"prefix_hits": 0, "prefix_lookups": 0, "prefills": 0,
                       "decode_steps": 0}
        # eviction tally on the device: no host sync per prefill
        self._ev_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        shape = (cfg.num_layers, cfg.num_kv_heads, total, ecfg.page, cfg.hd)
        self.pool_k = torch.zeros(shape, dtype=torch.bfloat16,
                                  device=self.device)
        self.pool_v = torch.zeros_like(self.pool_k)
        self.free = list(range(shared, total))
        self.slots: list[Optional[Request]] = [None] * ecfg.max_batch

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        if not 1 <= len(prompt) <= self.max_prompt:
            raise ValueError(
                f"prompt length {len(prompt)} outside [1, {self.max_prompt}]"
                " — raise EngineConfig.max_prompt (a page multiple "
                "<= max_seq) or truncate the prompt")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, prompt, max_new))
        return rid

    def step(self):
        """One engine iteration: admit + prefill waiting, decode running."""
        if self.ecfg.jitted:
            self._step_tick()
            return
        self._admit()
        for _ in range(self.ecfg.decode_block):
            self._decode()

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.waiting or self._any_running()) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    @property
    def stats(self) -> dict:
        """Engine counters, read from the device in one pull (the tick
        keeps them all in ``ServeState``)."""
        if self.ecfg.jitted:
            d = dict(zip(COUNTERS, self._state.counters.tolist()))
        else:
            d = dict(self._stats)
            d["evictions"] = int(self._ev_dev)
        d["degradation_events"] = events.count(start=self._events_start)
        return d

    def hit_ratio(self) -> float:
        st = self.stats
        if st["prefix_lookups"] == 0:
            return 0.0
        return st["prefix_hits"] / st["prefix_lookups"]

    def _any_running(self) -> bool:
        if self.ecfg.jitted:
            return bool(self.running)
        return any(self.slots)

    # --------------------------------------------------- device-resident tick
    def _init_tick(self, kstate, sketch, pages: int):
        """The static buffers, then the tick's two kinds: on the card each
        warmed up once on this idle engine (a no-op on its state: nothing
        is waiting or running, so only the sink page is written) and
        captured as a CUDA graph, the two sharing one memory pool; on the
        CPU the body runs eagerly at each tick."""
        cfg, ecfg, dev = self.cfg, self.ecfg, self.device
        s = ecfg.max_batch
        i32 = torch.int32

        def zeros(*shape, dtype=i32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        shape = (cfg.num_layers, cfg.num_kv_heads, pages, ecfg.page, cfg.hd)
        self._state = ServeState(
            kstate=kstate, sketch=sketch,
            pool_k=zeros(*shape, dtype=torch.bfloat16),
            pool_v=zeros(*shape, dtype=torch.bfloat16),
            owner=torch.full((ecfg.private_pages,), -1, dtype=i32,
                             device=dev),
            active=zeros(s, dtype=torch.bool), rid=zeros(s), pos=zeros(s),
            n_gen=zeros(s), max_new=zeros(s), last_tok=zeros(s),
            n_pages=zeros(s), page_tbl=zeros(s, self.pps),
            counters=zeros(len(COUNTERS)))
        pinned = dev.type == "cuda"
        # waiting lanes: staged on the host, copied in by the admit graph
        self._batch_host = torch.zeros((s, self.max_prompt + 4), dtype=i32,
                                       pin_memory=pinned)
        self._batch = zeros(s, self.max_prompt + 4)
        self._emitted = torch.zeros(
            sum(n for _, n in _emitted_sizes(ecfg)), dtype=i32,
            pin_memory=pinned)
        self._graphs = {}
        #: kernel launches each graph holds, by wrapper, counted by the
        #: wrappers at capture: every replay launches them all again
        self.graph_launches: dict = {}
        if dev.type != "cuda":
            return
        # the graphs replay on the stream they were captured on: kernel 5
        # keys its tickets by the launching stream (kernels/paged_attention)
        self._stream = stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # the warm-up builds the kernels, cuBLAS's handles and kernel 5's
        # tickets outside capture; an op that would sync raises here, with
        # its traceback, instead of invalidating the capture
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(stream):
                for kind in KINDS:
                    self._body(kind)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        stream.synchronize()
        pool = torch.cuda.graph_pool_handle()
        for kind in KINDS:
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                self._body(kind)
                _CAPTURES[("serve_tick", cfg.name, ecfg, kind)] += 1
            self._graphs[kind] = graph
            self.graph_launches[kind] = dict(_launch_counts() - before)
        self._done = torch.cuda.Event()

    def _body(self, kind: str):
        """One tick of ``kind`` on the static buffers: what a graph
        captures.  The emitted vector lands in (pinned) host memory."""
        admit = kind == "admit"
        if admit:
            self._batch.copy_(self._batch_host, non_blocking=True)
        em = _tick(self.cfg, self.ecfg, self.backend, self.sketch_cfg,
                   self.model, self._state, self._batch, admit)
        self._emitted.copy_(em, non_blocking=True)

    def _fetch(self) -> dict:
        """The tick's one host sync: wait for the tick, then read what it
        emitted -> {name: numpy array} (``_emitted_sizes``)."""
        if self.device.type == "cuda":
            self._done.synchronize()
        flat = self._emitted.numpy().copy()
        out, o = {}, 0
        for name, n in _emitted_sizes(self.ecfg):
            out[name] = flat[o:o + n]
            o += n
        return out

    def _step_tick(self):
        """One tick: stage the waiting lanes, run the admit graph if a
        request waits and a slot is free (else the decode graph), make the
        one host sync, then drain admissions, tokens and retirements."""
        ecfg = self.ecfg
        s, mp = ecfg.max_batch, self.max_prompt
        nwait = min(len(self.waiting), s)
        kind = "admit" if nwait and len(self.running) < s else "decode"
        if kind == "admit":
            hb = self._batch_host.numpy()
            hb[:] = 0
            for j, r in enumerate(self.waiting[:nwait]):
                hb[j, :len(r.prompt)] = r.prompt
                hb[j, mp:] = (len(r.prompt), r.max_new, r.rid, 1)
        if self.device.type == "cuda":
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._graphs[kind].replay()
                self._done.record()
        else:
            self._body(kind)
        self.ticks[kind] += 1
        if ecfg.sync_timeout_s > 0:
            # bounded retry/backoff, observable as degradation events, and
            # a WatchdogTimeout instead of an unbounded hang
            em = watch(self._fetch, timeout_s=ecfg.sync_timeout_s,
                       retries=ecfg.sync_retries, backoff=ecfg.sync_backoff,
                       component="engine.tick_sync")
        else:
            em = self._fetch()
        if em["clash"][0]:
            raise AssertionError("decode_paged: two lanes write one page")
        # admitted lanes are a prefix of the waiting queue (in-order
        # free-slot assignment + break-on-refusal)
        n_adm = int(em["admitted"].sum())
        newly = self.waiting[:n_adm]
        del self.waiting[:n_adm]
        for j, r in enumerate(newly):
            r.generated.append(int(em["pre_tok"][j]))
            r.prefix_hits = int(em["pre_hits"][j])
            r.prefix_lookups = int(em["pre_lookups"][j])
            r.pos = len(r.prompt)
            self.running[r.rid] = r
        rid = em["rid"]
        for dm, dt, rt in zip(em["dec_mask"].reshape(-1, s),
                              em["dec_tok"].reshape(-1, s),
                              em["retired"].reshape(-1, s)):
            for i in np.flatnonzero(dm):
                r = self.running[int(rid[i])]
                r.generated.append(int(dt[i]))
                r.pos += 1
            for i in np.flatnonzero(rt):
                r = self.running.pop(int(rid[i]))
                r.done = True
                self.finished[r.rid] = r

    # ------------------------------------------------------------ internals
    def _admit(self):
        for i in range(self.ecfg.max_batch):
            if self.slots[i] is None and self.waiting:
                req = self.waiting.pop(0)
                if self._prefill(req, i):
                    self.slots[i] = req
                else:
                    self.waiting.insert(0, req)  # no free pages: back off
                    break

    def _prefix_transaction(self, hashes: np.ndarray):
        """Fixed-width slot-returning prefix-chain transaction.

        Pads the block chain to ``max_prompt // page`` lanes and runs
        TinyLFU record -> peek_victims -> admit, then get and the
        slot-returning put.  -> (n_hit, pages int64 [n_full]) where
        ``pages[i]`` is block i's page id (hit or fresh insert) or -1.
        """
        pbw = self.pbw
        n_full = len(hashes)
        keys = np.zeros(pbw, np.uint32)
        keys[:n_full] = hashes
        valid = torch.from_numpy(np.arange(pbw) < n_full).to(self.device)
        admit_mask = None
        if self.sketch is not None:
            lanes = key_tensor(keys, self.device)
            self.sketch = admission.record(self.sketch_cfg, self.sketch,
                                           lanes, enabled=valid)
            vk, vv = self.backend.peek_victims(self.kstate, keys)
            admit_mask = admission.admit(self.sketch_cfg, self.sketch, lanes,
                                         vk, vv)
        self.kstate, hit, vals = self.backend.get(self.kstate, keys,
                                                  enabled=valid)
        self.kstate, _, ev, ss, sw = self.backend.put(
            self.kstate, keys, np.zeros(pbw, np.int32), admit=admit_mask,
            enabled=valid & ~hit, slot_value=True)
        self._ev_dev += ev.sum()
        hit_h, vals_h, ss_h, sw_h = (t.cpu().numpy()
                                     for t in (hit, vals, ss, sw))
        pages = np.where(hit_h, vals_h,
                         np.where(ss_h >= 0, ss_h * self.kcfg.ways + sw_h,
                                  -1))[:n_full].astype(np.int64)
        chain = np.cumprod(hit_h[:n_full].astype(np.int64))
        return int(chain.sum()), pages

    def _prefill(self, req: Request, slot: int) -> bool:
        page = self.ecfg.page
        prompt = req.prompt
        ntok = len(prompt)
        hashes = prefix_block_hashes(prompt, page)
        n_full = len(hashes)
        tail = ntok - n_full * page
        n_hit, pages_blk = self._prefix_transaction(hashes)
        req.prefix_lookups = n_full
        req.prefix_hits = n_hit
        self._stats["prefix_lookups"] += n_full
        self._stats["prefix_hits"] += n_hit

        need_private = (1 if tail else 0) + int((pages_blk < 0).sum())
        if len(self.free) < need_private + 2:
            return False

        padded = np.zeros((1, self.max_prompt), np.int32)
        padded[0, :ntok] = prompt
        logits, ks, vs = pm.prefill_padded(
            self.cfg, self.model, torch.from_numpy(padded).to(self.device),
            torch.tensor([ntok], dtype=torch.int32, device=self.device))
        self._stats["prefills"] += 1

        # full blocks the cache did not admit get private pages
        pages = []
        for j in range(n_full):
            p = int(pages_blk[j])
            if p < 0:
                p = self.free.pop()
                req.private.append(p)
            pages.append(p)
        if n_full > n_hit:
            # K/V from the first chain miss on (later resident blocks are
            # rewritten with identical content, as in the reference)
            seg = slice(n_hit * page, n_full * page)
            pm.write_pages(
                self.cfg, (ks[:, :, seg], vs[:, :, seg]),
                torch.tensor([pages[n_hit:]], dtype=torch.int64),
                self.pool_k, self.pool_v,
                torch.ones((1, n_full - n_hit), dtype=torch.bool))
        if tail:
            # tail tokens -> one private page, zero-padded
            p = self.free.pop()
            req.private.append(p)
            pages.append(p)
            seg = slice(n_full * page, n_full * page + tail)
            kt = torch.zeros((self.cfg.num_layers, 1, page,
                              self.cfg.num_kv_heads, self.cfg.hd),
                             dtype=torch.bfloat16, device=self.device)
            vt = torch.zeros_like(kt)
            kt[:, :, :tail] = ks[:, :, seg]
            vt[:, :, :tail] = vs[:, :, seg]
            pm.write_pages(self.cfg, (kt, vt),
                           torch.tensor([[p]], dtype=torch.int64),
                           self.pool_k, self.pool_v,
                           torch.ones((1, 1), dtype=torch.bool))
        req.pages = pages
        req.pos = ntok
        req.slot = slot
        req.generated.append(int(_argmax(logits[0])))
        return True

    def _page_table(self):
        b = self.ecfg.max_batch
        pt = np.zeros((b, self.pps), np.int32)
        pos = np.zeros(b, np.int32)
        tok = np.zeros(b, np.int32)
        active = np.zeros(b, bool)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            pt[i, : len(req.pages)] = req.pages
            pos[i] = req.pos
            tok[i] = req.generated[-1]
            active[i] = True
        return pt, pos, tok, active

    def _decode(self):
        # Every running request gets a page for its incoming token BEFORE the
        # batch table is built: one that cannot get one finishes, and
        # retires, in this very step.
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            if req.pos % self.ecfg.page == 0 and \
                    req.pos // self.ecfg.page >= len(req.pages):
                if not self.free:
                    req.done = True  # out of pages: finish early
                    self._retire(i)
                    continue
                p = self.free.pop()
                req.private.append(p)
                req.pages.append(p)
        pt, pos, tok, active = self._page_table()
        if not active.any():
            return
        dev = self.device
        logits, self.pool_k, self.pool_v = pm.decode_paged(
            self.cfg, self.model, torch.from_numpy(tok).to(dev),
            torch.from_numpy(pos).to(dev), self.pool_k, self.pool_v,
            torch.from_numpy(pt).to(dev), torch.from_numpy(active).to(dev))
        nxt = _sample_next(self.ecfg, logits,
                           self._stats["decode_steps"]).cpu().numpy()
        self._stats["decode_steps"] += 1
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            req.pos += 1
            req.generated.append(int(nxt[i]))
            if len(req.generated) >= req.max_new + 1 or \
                    req.pos >= self.ecfg.max_seq - 1:
                req.done = True
                self._retire(i)

    def _retire(self, slot: int):
        req = self.slots[slot]
        self.free.extend(req.private)
        req.private = []
        self.finished[req.rid] = req
        self.slots[slot] = None
