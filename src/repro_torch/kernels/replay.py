"""Whole-trace replay in one launch: Hopper kernels 3 and 4 and their plain
versions.

Kernel 3 (``replay_resident``, ``csrc/replay.cu``) replaces the Pallas TPU
kernel ``repro/kernels/replay.py`` ``replay_resident`` with its flat, TTL
and TinyLFU branches.  Its plain version is the chunked loop over the torch
twin's ``kway.access`` (``kway.replay_chunks``; with TinyLFU
``admission.replay_chunks``: record -> peek -> admit -> access), which the
``torch`` backend's ``CacheBackend.replay`` runs too.  The chunked
semantics split exactly by set, so kernel 3 replays set ranges (owners of
``2**owner_shift(S)`` sets) in parallel: ``bucket_lanes`` groups the
enabled lanes by owner (a stable counting sort on the card), then one warp
per owner walks its lanes (the ``"owners"`` form, flat and TTL), or, with
TinyLFU, a cooperative grid synchronises once per phase of each chunk (the
``"grid"`` form); chunks narrower than ``TL_GRID_MIN_BATCH`` run TinyLFU in
one thread block (the ``"block"`` form).  ``replay_form`` decides by shape.

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

#: Most lanes per chunk: kernel 3's block form stages a chunk's lanes in
#: shared memory (14 B each, within the 227 KB a block can use).
MAX_BATCH = 16384
#: Kernel 3's owners: ranges of 2**owner_shift(S) consecutive sets, at
#: least 2**OWNER_SHIFT_MIN sets each and at most MAX_OWNERS of them (the
#: bucketing counts owners in 32 KiB of shared memory).
OWNER_SHIFT_MIN = 4
MAX_OWNERS = 2**13
#: Warps per block of kernel 3's owners form (``kOwnerWarps``).
OWNER_WARPS = 4
#: Lanes per segment of kernel 3's bucketing (at least; at most
#: MAX_SEGMENTS segments, so its (segment, owner) counts stay <= 32 MiB).
BUCKET_SEGMENT = 4096
MAX_SEGMENTS = 1024
#: TinyLFU chunks of fewer lanes run in kernel 3's one-block form: below
#: it, two grid barriers per chunk cost more than one SM walking the chunk
#: (measured on an H100 by chip_smoke.py; PERF.md section 6).
TL_GRID_MIN_BATCH = 16
#: L2 rows kernel 4 copies ahead of its chain (``kRing`` of
#: ``csrc/replay_hier.cu``), 6 int32 lanes of 32 x NJ ways each.
HIER_RING = 8

_TRACE_COUNTS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
#: kernel 3's forms, by their number in csrc/replay.cu
_FORMS = ("owners", "grid", "block")


def trace_counts() -> dict:
    """Launch tally keyed by ("launch", policy, S, ways, steps, batch, ttl,
    tinylfu, form) for kernel 3 (form: ``replay_form``) and ("launch-hier", policy, l1_sets, l1_ways,
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
        return key[0] == "launch" and key[7] == (kind == "tinylfu")

    return sum(n for key, n in _TRACE_COUNTS.items() if match(key))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("replay")
    lib.replay_bucket_launch.argtypes = [_P] * 3 + [_I] * 6 + [_P] * 9
    lib.replay_bucket_launch.restype = _I
    lib.replay_launch.argtypes = ([_P] * 11 + [_I] * 6 + [_P] * 7 + [_I] * 3
                                  + [_P] * 7 + [_I] * 3 + [_P])
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
def _smem_optin(device: torch.device) -> int | None:
    """``device``'s opt-in shared memory per block in bytes; None off the
    card, where the wrappers run the plain versions, which use none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def _smem_fits(need: int, device) -> bool:
    """Whether ``need`` bytes of shared memory per block fit ``device``
    (always off the card)."""
    optin = _smem_optin(torch.device(device))
    return optin is None or need <= optin


def hier_l1_form(cfg: kway.KWayConfig, hier, expiry: bool, device) -> str:
    """``"shared"`` when kernel 4's ring and L1 fit ``device``'s opt-in
    shared memory per block, else ``"global"`` (a rule on size: both forms
    compute the same)."""
    ring, l1 = hier_smem_bytes(cfg, hier, expiry)
    return "shared" if _smem_fits(ring + l1, device) else "global"


def _ptr(t):
    return None if t is None else t.data_ptr()


def owner_shift(num_sets: int) -> int:
    """log2 of the sets per owner of kernel 3: 16 sets, or more when there
    would be more than ``MAX_OWNERS`` owners (131072 sets: 8192 owners)."""
    return max(OWNER_SHIFT_MIN,
               num_sets.bit_length() - MAX_OWNERS.bit_length())


def num_owners(num_sets: int) -> int:
    return max(1, num_sets >> owner_shift(num_sets))


def resident_smem_bytes(cfg: kway.KWayConfig, batch: int,
                        tinylfu: bool) -> int:
    """Shared memory per block that kernel 3's form for chunks of ``batch``
    lanes needs at its smallest (``csrc/replay.cu`` ``launch_owners``,
    ``launch_grid``, ``launch_block``): the owners form, ``OWNER_WARPS``
    warps' scratch; the grid form, one warp's (it halves its warps per
    block down to one to fit); the block form, 14 B a lane."""
    form = replay_form(batch, tinylfu)
    if form == "block":
        return 14 * batch
    # a warp's scratch (``scratch_ints``): a count per set of its owner,
    # 3 ints per listed inserting lane, with TinyLFU a bit per lane
    ints = (1 << owner_shift(cfg.num_sets)) + 3 * insert_cap(cfg, batch)
    if form == "grid":
        return 4 * (ints + -(-batch // 32))
    return OWNER_WARPS * 4 * ints


def smem_limit(device) -> int | None:
    """The shared memory per block kernel 3's size rule holds a shape to
    on ``device``: an open ``smem_budget``, else the card's opt-in (None off
    the card: no limit)."""
    from repro_torch.core import backend
    if backend.SMEM_BUDGET is not None:
        return backend.SMEM_BUDGET
    return _smem_optin(torch.device(device))


def resident_fits(cfg: kway.KWayConfig, batch: int, tinylfu: bool,
                  device) -> bool:
    """Whether kernel 3 takes chunks of ``batch`` lanes of ``cfg`` on
    ``device`` (a rule on size, the same as the C entry's checks): at most
    ``MAX_BATCH`` lanes, and on the card its form's shared memory within
    the opt-in per block, or, while ``core.backend.smem_budget`` is open,
    within that budget on any device.  ``CudaBackend.replay`` runs the
    chunked path where it does not."""
    limit = smem_limit(device)
    return batch <= MAX_BATCH and (
        limit is None or resident_smem_bytes(cfg, batch, tinylfu) <= limit)


def insert_cap(cfg: kway.KWayConfig, batch: int) -> int:
    """Inserting lanes a group of kernel 3 can list: at most ``ways`` per
    set of its owner."""
    return min(batch, cfg.ways << owner_shift(cfg.num_sets))


def replay_form(batch: int, tinylfu: bool) -> str:
    """Kernel 3's form for chunks of ``batch`` lanes (a rule on shape: every
    form computes the same): ``"owners"`` without TinyLFU, with it
    ``"grid"``, or ``"block"`` below ``TL_GRID_MIN_BATCH`` lanes."""
    if not tinylfu:
        return "owners"
    return "grid" if batch >= TL_GRID_MIN_BATCH else "block"


@dataclasses.dataclass
class Buckets:
    """The enabled lanes of a [T, B] trace grouped by owner: positions
    ``start[o]:start[o+1]`` hold owner o's lanes in (t, i) order, each as its
    flat index ``t*B+i`` (``lane``), key and set; positions from
    ``start[-1]`` on are unspecified.  ``pos[t*B+i]`` is the position of an
    enabled lane (unspecified for the others).  ``live``: enabled lanes per
    chunk."""

    lane: torch.Tensor   # int32 [T*B]
    key: torch.Tensor    # int32 [T*B]
    set: torch.Tensor    # int32 [T*B]
    pos: torch.Tensor    # int32 [T*B]: each enabled lane's position
    start: torch.Tensor  # int32 [owners + 1]
    live: torch.Tensor   # int32 [T]


def bucket_segment(n: int) -> int:
    """Lanes per segment of the bucketing kernel for ``n`` lanes."""
    per = -(-n // MAX_SEGMENTS)
    return max(BUCKET_SEGMENT, -(-per // 32) * 32)


def bucket_lanes_ref(qk, sets, enabled, num_sets: int) -> Buckets:
    """Plain version of kernel 3's bucketing: a stable sort of the enabled
    lanes by owner.  ``qk`` / ``sets`` int32 [T, B] (sanitized keys and
    their sets), ``enabled`` bool [T, B]."""
    steps, batch = qk.shape
    shift, owners = owner_shift(num_sets), num_owners(num_sets)
    en = enabled.reshape(-1)
    own = sets.reshape(-1).to(torch.int64) >> shift
    order = torch.sort(torch.where(en, own, owners), stable=True).indices
    m = int(en.sum())
    lane = torch.full_like(en, -1, dtype=torch.int32)
    lane[:m] = order[:m].to(torch.int32)
    pick = lane[:m].long()
    key = torch.zeros_like(lane)
    key[:m] = qk.reshape(-1)[pick]
    st = torch.zeros_like(lane)
    st[:m] = sets.reshape(-1)[pick].to(torch.int32)
    pos = torch.zeros_like(lane)
    pos[pick] = torch.arange(m, dtype=torch.int32)
    start = torch.zeros(owners + 1, dtype=torch.int32, device=qk.device)
    start[1:] = torch.cumsum(torch.bincount(own[en], minlength=owners), 0)
    return Buckets(lane=lane, key=key, set=st, pos=pos, start=start,
                   live=enabled.sum(1, dtype=torch.int32))


def bucket_lanes(qk, sets, enabled, num_sets: int) -> Buckets:
    """Kernel 3's bucketing (``replay_bucket_launch``: a stable counting
    sort on the card), or its plain version on CPU tensors."""
    if qk.device.type == "cpu":
        return bucket_lanes_ref(qk, sets, enabled, num_sets)
    steps, batch = qk.shape
    n = steps * batch
    dev = qk.device
    shift, owners = owner_shift(num_sets), num_owners(num_sets)
    seg = bucket_segment(n)
    out = Buckets(lane=torch.empty(n, dtype=torch.int32, device=dev),
                  key=torch.empty(n, dtype=torch.int32, device=dev),
                  set=torch.empty(n, dtype=torch.int32, device=dev),
                  pos=torch.empty(n, dtype=torch.int32, device=dev),
                  start=torch.empty(owners + 1, dtype=torch.int32,
                                    device=dev),
                  live=torch.empty(steps, dtype=torch.int32, device=dev))
    cnt = torch.empty(-(-n // seg) * owners, dtype=torch.int32, device=dev)
    tot = torch.empty(owners, dtype=torch.int32, device=dev)
    qk = qk.to(torch.int32).contiguous()
    sets = sets.to(torch.int32).contiguous()
    en = enabled.to(torch.bool).contiguous()
    rc = _lib().replay_bucket_launch(
        _ptr(qk), _ptr(sets), _ptr(en), n, steps, batch, seg, owners, shift,
        _ptr(cnt), _ptr(tot), _ptr(out.live), _ptr(out.lane), _ptr(out.key),
        _ptr(out.set), _ptr(out.pos), _ptr(out.start),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_resident bucketing")
    return out


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
    form = replay_form(batch, tinylfu is not None)
    bk = None
    if form != "block":
        bk = bucket_lanes(qk.view(steps, batch), sets.view(steps, batch),
                          en.view(steps, batch), cfg.num_sets)
    lanes, exp = _lanes(state, cfg.num_sets, cfg.ways)
    hits = torch.empty(steps, dtype=torch.int32, device=dev)
    evs = torch.empty_like(hits)
    clock = state.clock.to(torch.int32).reshape(1).contiguous()
    sk = door_win = rec = work = None
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
        if form == "grid":  # two chunks' work lists and their counts
            work = torch.empty(2 * batch + 2, dtype=torch.int32, device=dev)
        sk_ptrs = (_ptr(sk.packed), _ptr(sk.door), _ptr(sk.additions))
        width, door_bits, sample = (tinylfu.width, tinylfu.door_bits,
                                    tinylfu.sample)

    shift = owner_shift(cfg.num_sets)
    cap = insert_cap(cfg, batch)
    rc = _lib().replay_launch(
        _ptr(lanes["keys"]), _ptr(lanes["fprint"]), _ptr(lanes["vals"]),
        _ptr(lanes["meta_a"]), _ptr(lanes["meta_b"]), _ptr(exp), _ptr(clock),
        _ptr(qk), _ptr(sets), _ptr(en), _ptr(tt), steps, batch, cfg.ways,
        cfg.num_sets, int(cfg.policy), _FORMS.index(form),
        *((None,) * 6 if bk is None else
          (_ptr(bk.lane), _ptr(bk.key), _ptr(bk.set), _ptr(bk.start),
           _ptr(bk.live), _ptr(bk.pos))), _ptr(work),
        num_owners(cfg.num_sets), shift, cap, _ptr(hits), _ptr(evs),
        *sk_ptrs, _ptr(door_win), _ptr(rec), width,
        door_bits, sample, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_resident")
    _TRACE_COUNTS[("launch", int(cfg.policy), cfg.num_sets, cfg.ways, steps,
                   batch, exp is not None, tinylfu is not None, form)] += 1
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
