"""Whole-trace replay in one launch: Hopper kernels 3 and 4 and their plain
versions.

Kernel 3 (``replay_resident``, ``csrc/replay.cu``) replaces the Pallas TPU
kernel ``repro/kernels/replay.py`` ``replay_resident`` with its flat, TTL
and TinyLFU branches.  Its plain version is the chunked loop over the torch
twin's ``kway.access`` (``kway.replay_chunks``; with TinyLFU
``admission.replay_chunks``: record -> peek -> admit -> access), which the
``torch`` backend's ``CacheBackend.replay`` runs too.

Kernel 4 (``replay_hierarchical``, ``csrc/replay_hier.cu``) replaces the
Pallas TPU kernel ``replay_hierarchical``: the exclusive L1-over-L2 replay.
Its plain version is ``core/hierarchy.replay_l1_over_l2``.  It keeps the
L1 in shared memory for the launch when the L1 and its ring of prefetched
L2 rows fit the card's opt-in shared memory per block (the ``"shared"``
form), else in HBM (the ``"global"`` form): ``hier_l1_form`` decides by
size.

Both kernels equal their plain versions bit for bit: per-chunk hits and
evictions, the final state(s) and the final sketch.  On CPU tensors a
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.  ``trace_counts()`` tallies launches by shape, as the reference's
does (there is no compilation step to count).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import admission, hashing, hierarchy, kway
from repro_torch.kernels import _build
from repro_torch.kernels.kway_probe import MAX_WAYS

#: Most lanes per chunk: the chunk's lanes are staged in shared memory
#: (14 B each, within the 227 KB a block can use).
MAX_BATCH = 16384
#: L2 rows kernel 4 copies ahead of its chain (``kRing`` of
#: ``csrc/replay_hier.cu``), 6 int32 lanes of 32 x NJ ways each.
HIER_RING = 8

_TRACE_COUNTS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def trace_counts() -> dict:
    """Launch tally keyed by ("launch", policy, S, ways, steps, batch, ttl,
    tinylfu) for kernel 3 and ("launch-hier", policy, l1_sets, l1_ways,
    l2_sets, l2_ways, steps, batch, promote, demote, ttl) for kernel 4."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


def launches(kind: str = "flat") -> int:
    """Launches since the last reset of kernel 3 without TinyLFU
    (``"flat"``, TTL runs included), with TinyLFU (``"tinylfu"``), or of
    kernel 4 (``"hier"``)."""
    if kind not in ("flat", "tinylfu", "hier"):
        raise ValueError(f"kind must be 'flat', 'tinylfu' or 'hier', got "
                         f"{kind!r}")

    def match(key):
        if kind == "hier":
            return key[0] == "launch-hier"
        return key[0] == "launch" and key[-1] == (kind == "tinylfu")

    return sum(n for key, n in _TRACE_COUNTS.items() if match(key))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("replay")
    lib.replay_launch.argtypes = ([_P] * 11 + [_I] * 5 + [_P] * 8 + [_I] * 3
                                  + [_P])
    lib.replay_launch.restype = _I
    return lib


@functools.cache
def _hier_lib() -> ctypes.CDLL:
    lib = _build.library("replay_hier")
    lib.replay_hier_launch.argtypes = [_P] * 16 + [_I] * 12 + [_P] * 3
    lib.replay_hier_launch.restype = _I
    return lib


def hier_smem_bytes(cfg: kway.KWayConfig, hier, expiry: bool) -> tuple:
    """(ring bytes, L1 bytes) of kernel 4's shared memory: its ring of
    ``HIER_RING`` L2 rows, and the L1's lanes (with the expiry lane when the
    tiers carry one), which only the ``"shared"`` form holds there."""
    widest = max(cfg.ways, hier.l1_ways)
    nj = 1 if widest <= 32 else 2 if widest <= 64 else 4
    lanes = len(kway.STATE_LANES) + bool(expiry)
    return (4 * HIER_RING * 6 * 32 * nj,
            4 * lanes * hier.l1_sets * hier.l1_ways)


@functools.cache
def _smem_optin(device: torch.device) -> int:
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def hier_l1_form(cfg: kway.KWayConfig, hier, expiry: bool, device) -> str:
    """``"shared"`` when kernel 4's ring and L1 fit ``device``'s opt-in
    shared memory per block, else ``"global"`` (a rule on size: both forms
    compute the same)."""
    ring, l1 = hier_smem_bytes(cfg, hier, expiry)
    fits = ring + l1 <= _smem_optin(torch.device(device))
    return "shared" if fits else "global"


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_ttl_tinylfu(ttls, tinylfu):
    if ttls is not None and tinylfu is not None:
        raise ValueError(admission.TTL_EXCLUSIVE)


def replay_ref(cfg: kway.KWayConfig, state: kway.KWayState, qkeys, enabled,
               ttls=None, tinylfu=None, sketch=None):
    """Plain version of kernel 3: the chunked loop over the torch twin's
    fused ``kway.access`` (payload ``val == key``), with TinyLFU the record
    -> peek -> admit -> access loop.  ``qkeys`` int32 [T, B] raw keys.
    -> (hits int32 [T], evs int32 [T], state', sketch' or None)."""
    _check_ttl_tinylfu(ttls, tinylfu)
    access = functools.partial(kway.access, cfg)
    if tinylfu is None:
        return kway.replay_chunks(access, state, qkeys, enabled, ttls) + (
            None,)
    if sketch is None:
        sketch = admission.make_sketch(tinylfu, state.device)
    return admission.replay_chunks(
        tinylfu, sketch, access, functools.partial(kway.peek_victims, cfg),
        state, qkeys, enabled)


def _streams(qkeys, enabled, ttls, dev):
    """Flattened kernel inputs: enable flags and TTLs on ``dev``."""
    if enabled.shape != qkeys.shape or (ttls is not None
                                        and ttls.shape != qkeys.shape):
        raise ValueError("enabled and ttls must match the [T, B] key chunks")
    steps, batch = qkeys.shape
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch must be in [1, {MAX_BATCH}], got {batch}")
    if 2 * steps * batch >= 2**31:
        raise ValueError("the replay clock would pass 2^31: trace too long")
    en = enabled.reshape(-1).to(device=dev, dtype=torch.bool).contiguous()
    tt = (None if ttls is None
          else ttls.reshape(-1).to(device=dev, dtype=torch.int32).contiguous())
    return en, tt


def _lanes(state: kway.KWayState, sets: int, ways: int):
    """Contiguous copies of a state's lanes (the kernels write in place):
    ({lane: tensor}, expiry or None)."""
    lanes = {f: getattr(state, f).contiguous().clone()
             for f in kway.STATE_LANES}
    exp = None if state.expiry is None else state.expiry.contiguous().clone()
    for t in (*lanes.values(), exp):
        if t is not None and (t.dtype != torch.int32
                              or t.shape != (sets, ways)):
            raise ValueError("state lanes must be int32 [S, ways]")
    return lanes, exp


def replay_resident(cfg: kway.KWayConfig, state: kway.KWayState, qkeys,
                    enabled, ttls=None, tinylfu=None, sketch=None):
    """Replay ``qkeys`` int32 [T, B] (raw key bit patterns) with lane mask
    ``enabled`` bool [T, B], optional ``ttls`` int32 [T, B] or TinyLFU
    admission (``tinylfu`` with an optional ``sketch``; fresh when None).
    A state with an expiry lane keeps it (inserts without a TTL never
    expire).  -> (hits int32 [T], evs int32 [T], state', sketch' or
    None)."""
    _check_ttl_tinylfu(ttls, tinylfu)
    dev = state.device
    if dev.type == "cpu":
        return replay_ref(cfg, state, qkeys, enabled, ttls, tinylfu, sketch)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    steps, batch = qkeys.shape
    if not 1 <= cfg.ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}], got {cfg.ways}")
    en, tt = _streams(qkeys, enabled, ttls, dev)
    if ttls is not None:
        state = kway.ensure_expiry(state)
    if tinylfu is not None and state.expiry is not None:
        raise ValueError("TinyLFU replay takes a state without an expiry "
                         "lane")

    # routing stays in torch: sanitize + set index, as the probe path does
    qk, sets = kway.route(cfg, qkeys.reshape(-1))
    qk = qk.contiguous()
    sets = sets.to(torch.int32).contiguous()
    lanes, exp = _lanes(state, cfg.num_sets, cfg.ways)
    winner = torch.full((cfg.num_sets * cfg.ways,), -1, dtype=torch.int32,
                        device=dev)
    hits = torch.empty(steps, dtype=torch.int32, device=dev)
    evs = torch.empty_like(hits)
    clock = state.clock.to(torch.int32).reshape(1).contiguous()
    sk = door_win = rec = None
    sk_ptrs = (None, None, None)
    width = door_bits = sample = 0
    if tinylfu is not None:
        if sketch is None:
            sketch = admission.make_sketch(tinylfu, dev)
        if (sketch.packed.shape != (admission.ROWS, tinylfu.width // 8)
                or sketch.door.shape != (tinylfu.door_bits // 32,)
                or sketch.device != dev):
            raise ValueError("sketch does not match the TinyLFU config")
        sk = admission.TinyLFUState(
            packed=sketch.packed.to(torch.int32).contiguous().clone(),
            door=sketch.door.to(torch.int32).contiguous().clone(),
            additions=sketch.additions.to(torch.int32).reshape(1).clone())
        door_win = torch.full_like(sk.door, -1)
        rec = torch.empty(admission.ROWS * batch, dtype=torch.int32,
                          device=dev)
        sk_ptrs = (_ptr(sk.packed), _ptr(sk.door), _ptr(sk.additions))
        width, door_bits, sample = (tinylfu.width, tinylfu.door_bits,
                                    tinylfu.sample)

    rc = _lib().replay_launch(
        _ptr(lanes["keys"]), _ptr(lanes["fprint"]), _ptr(lanes["vals"]),
        _ptr(lanes["meta_a"]), _ptr(lanes["meta_b"]), _ptr(exp), _ptr(clock),
        _ptr(qk), _ptr(sets), _ptr(en), _ptr(tt), steps, batch, cfg.ways,
        cfg.num_sets, int(cfg.policy), _ptr(winner), _ptr(hits), _ptr(evs),
        *sk_ptrs, _ptr(door_win), _ptr(rec), width,
        door_bits, sample, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_resident")
    _TRACE_COUNTS[("launch", int(cfg.policy), cfg.num_sets, cfg.ways, steps,
                   batch, exp is not None, tinylfu is not None)] += 1
    out = dataclasses.replace(
        state, **lanes, expiry=exp,
        clock=state.clock + 2 * batch * steps)
    if sk is not None:
        sk = dataclasses.replace(sk, additions=sk.additions.reshape(()))
    return hits, evs, out, sk


def replay_hierarchical(cfg: kway.KWayConfig, hier, state, qkeys, enabled,
                        ttls=None):
    """Replay ``qkeys`` int32 [T, B] (raw key bit patterns), ``enabled``
    bool [T, B] and optional ``ttls`` int32 [T, B] through the L1-over-L2
    hierarchy ``state`` (a ``HierState``).  If either tier, or ``ttls``,
    brings an expiry lane, both tiers carry one.
    -> (hits int32 [T], evs int32 [T], HierState', None)."""
    dev = state.l2.device
    if dev.type == "cpu":
        return hierarchy.replay_l1_over_l2(cfg, hier, state, qkeys, enabled,
                                           ttls)
    if dev.type != "cuda":
        raise ValueError(f"no hierarchy replay kernel for device {dev}")
    if not hier.enabled:
        raise ValueError("replay_hierarchical needs l1_sets > 0")
    if not 1 <= cfg.ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}], got {cfg.ways}")
    steps, batch = qkeys.shape
    en, tt = _streams(qkeys, enabled, ttls, dev)
    state = hierarchy.carried_tiers(state, ttls is not None)
    if state.l1.device != dev:
        raise ValueError("both tiers must lie on one device")

    # the kernel hashes the sanitized keys to their L1 and L2 sets itself:
    # it must hash every demoted key anyway
    qk = hashing.sanitize_keys(qkeys.reshape(-1)).contiguous()
    l1, e1 = _lanes(state.l1, hier.l1_sets, hier.l1_ways)
    l2, e2 = _lanes(state.l2, cfg.num_sets, cfg.ways)
    hits = torch.empty(steps, dtype=torch.int32, device=dev)
    evs = torch.empty_like(hits)
    clock = state.l2.clock.to(torch.int32).reshape(1).contiguous()
    form = hier_l1_form(cfg, hier, e1 is not None, dev)

    rc = _hier_lib().replay_hier_launch(
        *(_ptr(l1[f]) for f in kway.STATE_LANES), _ptr(e1),
        *(_ptr(l2[f]) for f in kway.STATE_LANES), _ptr(e2), _ptr(clock),
        _ptr(qk), _ptr(en), _ptr(tt), steps, batch, hier.l1_sets,
        hier.l1_ways, cfg.num_sets, cfg.ways,
        cfg.seed ^ hierarchy.L1_SEED_SALT, cfg.seed, int(cfg.policy),
        int(hier.promote), int(hier.demote), int(form == "shared"),
        _ptr(hits), _ptr(evs), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_hierarchical")
    _TRACE_COUNTS[("launch-hier", int(cfg.policy), hier.l1_sets,
                   hier.l1_ways, cfg.num_sets, cfg.ways, steps, batch,
                   hier.promote, hier.demote, ttls is not None, form)] += 1
    clock_f = state.l2.clock + 2 * batch * steps
    out = hierarchy.HierState(
        l1=kway.KWayState(**l1, clock=clock_f.clone(), expiry=e1),
        l2=kway.KWayState(**l2, clock=clock_f, expiry=e2))
    return hits, evs, out, None
