"""TinyLFU admission filter (torch): count-min sketch + doorkeeper + aging.

Counterpart of ``repro/core/admission.py``, bit for bit:

  * a count-min sketch of 4 hash rows of 4-bit saturating counters, packed
    8 to a 32-bit word (row ``r`` hashes with seed ``0xA000 + r``);
  * a doorkeeper Bloom filter (seed ``0xD00E``) that absorbs one-hit
    wonders;
  * aging: once ``additions`` reaches ``sample``, every counter is halved,
    the doorkeeper cleared and ``additions`` zeroed.

All hashes run on ``sanitize_keys`` output.  The sketch words are uint32
values held as **int32 bit patterns** (as keys are in the port): torch on
the CPU has no ``>>``, ``+`` or ``scatter_reduce`` for uint32, so the
arithmetic runs in int64 masked to 32 bits.

``record`` keeps the reference's batched semantics exactly:
  * the doorkeeper test reads the PRE-chunk door, and each door word is
    SET to ``pre | bit`` of the LAST enabled lane that maps to it (the
    reference's scatter-set), not an OR of every lane's bit;
  * counter increments are computed from the pre-chunk words and merge by
    a max of whole uint32 words, so two lanes that raise different nibbles
    of one word keep only the larger word;
  * disabled lanes touch neither the door, the counters nor ``additions``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.kway import _last_writer

ROWS = 4
_ROW_SEED = 0xA000
_DOOR_SEED = 0xD00E

#: TinyLFU and per-request TTLs exclude each other, as in the reference.
TTL_EXCLUSIVE = ("per-request TTLs and TinyLFU admission are mutually "
                 "exclusive (the sketch has no expiry-aware semantics)")


@dataclasses.dataclass
class TinyLFUState:
    packed: torch.Tensor     # int32 [ROWS, W/8]: 8 x 4-bit counters per word
    door: torch.Tensor       # int32 [DW]: doorkeeper bits
    additions: torch.Tensor  # int32 []: additions since the last aging

    @property
    def device(self) -> torch.device:
        return self.packed.device


@dataclasses.dataclass(frozen=True)
class TinyLFUConfig:
    width: int        # counters per row (power of two, multiple of 8)
    door_bits: int    # doorkeeper bits (power of two)
    sample: int       # aging period W (count of additions)

    def __post_init__(self):
        assert self.width % 8 == 0 and self.width & (self.width - 1) == 0
        assert self.door_bits & (self.door_bits - 1) == 0

    def nbytes(self) -> int:
        """Bytes of the sketch: the counter words and the door words."""
        return ROWS * self.width // 2 + self.door_bits // 8


def for_capacity(capacity: int) -> TinyLFUConfig:
    """Standard sizing: about one counter per cached item."""
    width = max(64, 1 << (capacity - 1).bit_length())
    return TinyLFUConfig(width=width, door_bits=width * 2, sample=capacity * 8)


def make_sketch(cfg: TinyLFUConfig, device) -> TinyLFUState:
    return TinyLFUState(
        packed=torch.zeros((ROWS, cfg.width // 8), dtype=torch.int32,
                           device=device),
        door=torch.zeros((cfg.door_bits // 32,), dtype=torch.int32,
                         device=device),
        additions=torch.zeros((), dtype=torch.int32, device=device))


def sketch_from_numpy(arrays: dict, *, device) -> TinyLFUState:
    """A reference ``TinyLFUState``'s leaves as numpy arrays (uint32
    packed/door, int32 additions) -> port sketch; a per-shard stack's
    leading ``[D]`` axis carries over."""
    def words(a):
        a = np.array(a)                       # a writable copy
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a.astype(np.int32)).to(device)

    return TinyLFUState(
        packed=words(arrays["packed"]), door=words(arrays["door"]),
        additions=torch.from_numpy(
            np.array(arrays["additions"], np.int32)).to(device))


def sketch_to_numpy(st: TinyLFUState) -> dict:
    """Port sketch -> the reference's leaves as numpy arrays."""
    return {"packed": st.packed.detach().cpu().numpy().view(np.uint32),
            "door": st.door.detach().cpu().numpy().view(np.uint32),
            "additions": st.additions.detach().cpu().numpy()}


def _positions(cfg: TinyLFUConfig, keys: torch.Tensor):
    """Per row: (word index, nibble shift) of each sanitized key, int64
    [ROWS, B]."""
    idx = torch.stack([hashing.hash_u32(keys, _ROW_SEED + r) & (cfg.width - 1)
                       for r in range(ROWS)])
    return idx >> 3, (idx & 7) * 4


def _door_pos(cfg: TinyLFUConfig, keys: torch.Tensor):
    """(door word, bit) of each sanitized key, int64 [B]."""
    dh = hashing.hash_u32(keys, _DOOR_SEED) & (cfg.door_bits - 1)
    return dh >> 5, dh & 31


def estimate(cfg: TinyLFUConfig, st: TinyLFUState, keys) -> torch.Tensor:
    """Count-min estimate, +1 if the doorkeeper has the key -> int32 [B]."""
    keys = hashing.sanitize_keys(keys)
    word, shift = _positions(cfg, keys)
    rows = torch.arange(ROWS, device=keys.device)[:, None]
    nib = (hashing.as_u32(st.packed[rows, word]) >> shift) & 0xF
    dword, dbit = _door_pos(cfg, keys)
    door = (hashing.as_u32(st.door[dword]) >> dbit) & 1
    return (nib.min(dim=0).values + door).to(torch.int32)


def _age(st: TinyLFUState) -> TinyLFUState:
    """Halve every 4-bit counter and clear the doorkeeper (TinyLFU reset)."""
    halved = (hashing.as_u32(st.packed) >> 1) & 0x77777777
    return TinyLFUState(packed=hashing.to_i32(halved),
                        door=torch.zeros_like(st.door),
                        additions=torch.zeros_like(st.additions))


def record(cfg: TinyLFUConfig, st: TinyLFUState, keys,
           enabled=None) -> TinyLFUState:
    """Record one access per enabled lane (batched; see the module
    docstring for the exact merge rules), then age once if ``additions``
    reached ``sample``.  ``keys`` are int32 key lanes on the sketch's
    device, ``enabled`` bool [B] or None."""
    keys = hashing.sanitize_keys(keys)
    if enabled is None:
        enabled = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    dword, dbit = _door_pos(cfg, keys)
    door = hashing.as_u32(st.door)
    dmask = torch.where(enabled, torch.ones_like(dbit) << dbit,
                        torch.zeros_like(dbit))
    in_door = (door[dword] & dmask) != 0
    keep = _last_writer(dword, enabled)
    n_door = door.numel()
    new_door = torch.cat([door, door.new_zeros(1)])
    new_door.index_put_((torch.where(keep, dword, n_door),),
                        door[dword] | dmask)

    word, shift = _positions(cfg, keys)
    w8 = cfg.width // 8
    flat = torch.arange(ROWS, device=keys.device)[:, None] * w8 + word
    packed = hashing.as_u32(st.packed).reshape(-1)
    cur = packed[flat]
    inc = in_door[None, :] & (((cur >> shift) & 0xF) < 15)
    src = torch.where(inc, cur + (torch.ones_like(shift) << shift),
                      torch.zeros_like(cur))
    packed = packed.scatter_reduce(0, flat.reshape(-1), src.reshape(-1),
                                   reduce="amax")

    additions = st.additions + enabled.sum(dtype=torch.int32)
    aged = additions >= cfg.sample
    new = TinyLFUState(packed=hashing.to_i32(packed).reshape(st.packed.shape),
                       door=hashing.to_i32(new_door[:n_door]),
                       additions=additions)
    halved = _age(new)
    # one aging check per call, without a host sync
    return TinyLFUState(packed=torch.where(aged, halved.packed, new.packed),
                        door=torch.where(aged, halved.door, new.door),
                        additions=torch.where(aged, halved.additions,
                                              additions))


def admit(cfg: TinyLFUConfig, st: TinyLFUState, cand_keys, victim_keys,
          victim_valid) -> torch.Tensor:
    """TinyLFU decision: admit iff est(candidate) > est(victim), or the slot
    is empty -> bool [B]."""
    ce = estimate(cfg, st, cand_keys)
    ve = estimate(cfg, st, victim_keys)
    return (~victim_valid) | (ce > ve)


def replay_chunks(cfg: TinyLFUConfig, sketch: TinyLFUState, access,
                  peek_victims, state, qkeys, enabled):
    """The chunked replay with TinyLFU admission: per chunk ``record`` the
    enabled lanes, peek each lane's victim on the pre-hit state, ``admit``
    on the post-record sketch, then ``access(state, keys, vals, admit,
    enabled)`` (payload ``val == key``).  The plain version of kernel 3's
    TinyLFU branch.  ``qkeys`` int32 [T, B] and ``enabled`` bool [T, B] on
    the state's device.  -> (hits int32 [T], evs int32 [T], state',
    sketch')."""
    hits = torch.zeros(qkeys.shape[0], dtype=torch.int32, device=qkeys.device)
    evs = torch.zeros_like(hits)
    for t in range(qkeys.shape[0]):
        keys, en = qkeys[t], enabled[t]
        sketch = record(cfg, sketch, keys, en)
        vk, vv = peek_victims(state, keys)
        ok = admit(cfg, sketch, keys, vk, vv)
        state, hit, _, _, ev = access(state, keys, keys, ok, en)
        hits[t] = hit.sum()
        evs[t] = ev.sum()
    return hits, evs, state, sketch
