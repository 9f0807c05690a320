"""Continuous-batching serving engine with a k-way set-associative prefix
cache: the paper's cache as the page-residency manager of a paged KV cache.

Counterpart of the host loop of ``repro/serve/engine.py``
(``EngineConfig(jitted=False)``, the reference's differential oracle).
The page pool is split into

  * a **shared region** of exactly ``num_sets x ways`` pages, owned 1:1 by
    the k-way cache slots (cache value == page id).  A full prompt block
    (``page`` tokens), keyed by its prefix-chain hash, lives there at most
    once; the eviction policy (and optional TinyLFU admission) decides
    residency, and evicting a key frees its page;
  * a **private region** for tail and decode pages (a partial block is not
    content-addressable until it is full).

Each admitted prompt runs one fixed-width prefix transaction over
``max_prompt // page`` block lanes (TinyLFU record -> peek_victims ->
admit, then get and a slot-returning put), one padded prefill, and writes
its K/V from the first chain miss on; each engine step then runs
``decode_block`` batched paged decode steps (kernel 5 on the card) with
greedy sampling.  The prefix cache runs on any of the port's backends
(``torch``, ``cuda``, ``ref``).

Not ported yet, and refused with a ``ValueError`` naming the ROADMAP item:
the device-resident jitted tick (``jitted=True``; its counterpart is a CUDA
graph), temperature sampling, a sharded prefix cache, and models with
experts or SSM layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import admission
from repro_torch.core.backend import make_backend, resolve_device
from repro_torch.core.hashing import key_tensor, prefix_block_hashes
from repro_torch.core.kway import KWayConfig
from repro_torch.core.policies import Policy
from repro_torch.models import lm
from repro_torch.robust import events
from repro_torch.serve import paged_model as pm

JITTED_TODO = ("the device-resident serving tick (jitted=True) is not "
               "ported yet (ROADMAP Queue A item 12; its torch counterpart "
               "is a CUDA graph): use the host loop")
TEMPERATURE_TODO = ("temperature sampling is not ported yet (ROADMAP Queue "
                    "A item 12: jax.random.categorical has no bit-equal "
                    "torch counterpart, so the sampler needs its own "
                    "design); use temperature=0 (greedy)")
SHARDS_TODO = ("a sharded prefix cache is not ported yet (ROADMAP Queue A "
               "item 8, core/sharded.py)")


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
    # > 1 would set-shard the prefix cache: not ported yet (refused)
    shards: int = 1
    # True would run the device-resident tick: not ported yet (refused)
    jitted: bool = False
    # Static prompt-width ceiling for the fixed-width prefix transaction and
    # the padded prefill (0: max_seq).  Must be a multiple of ``page``;
    # longer prompts are rejected at submit().
    max_prompt: int = 0
    # 0: greedy decode (argmax).  > 0 would sample: not ported yet (refused)
    temperature: float = 0.0
    # Decode steps per engine step (multi-step scheduling): admit, then
    # ``decode_block`` decodes; page allocation order, and so out-of-page
    # retirement, follows this schedule.
    decode_block: int = 1


def _sample_next(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token: argmax, ties to the first index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


class Engine:
    """Host-loop serving engine.  ``model`` is an ``lm.LM`` whose
    parameters lie on ``device`` (None: the card)."""

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
        if ecfg.jitted:
            raise ValueError(JITTED_TODO)
        if ecfg.shards > 1:
            raise ValueError(SHARDS_TODO)
        if ecfg.temperature > 0.0:
            raise ValueError(TEMPERATURE_TODO)
        lm.check_dense(cfg)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model parameters lie on {model.device}, the "
                             f"engine runs on {self.device}")
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self._events_start = events.cursor()
        self.kcfg = KWayConfig(num_sets=ecfg.num_sets, ways=ecfg.ways,
                               policy=ecfg.policy)
        self.backend = make_backend(ecfg.backend, self.kcfg, self.device)
        self.kstate = self.backend.init()
        self.sketch_cfg = (admission.for_capacity(self.kcfg.capacity)
                           if ecfg.tinylfu else None)
        self.sketch = (admission.make_sketch(self.sketch_cfg, self.device)
                       if ecfg.tinylfu else None)
        shared = self.kcfg.capacity
        total = shared + ecfg.private_pages
        shape = (cfg.num_layers, cfg.num_kv_heads, total, ecfg.page, cfg.hd)
        self.pps = ecfg.max_seq // ecfg.page
        self.pbw = self.max_prompt // ecfg.page
        self.waiting: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._stats = {"prefix_hits": 0, "prefix_lookups": 0, "prefills": 0,
                       "decode_steps": 0}
        # eviction tally on the device: no host sync per prefill
        self._ev_dev = torch.zeros((), dtype=torch.int64, device=self.device)
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
        self._admit()
        for _ in range(self.ecfg.decode_block):
            self._decode()

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.waiting or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    @property
    def stats(self) -> dict:
        d = dict(self._stats)
        d["evictions"] = int(self._ev_dev)
        d["degradation_events"] = events.count(start=self._events_start)
        return d

    def hit_ratio(self) -> float:
        st = self.stats
        if st["prefix_lookups"] == 0:
            return 0.0
        return st["prefix_hits"] / st["prefix_lookups"]

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
        req.generated.append(int(_sample_next(logits[0])))
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
        nxt = _sample_next(logits).cpu().numpy()
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
