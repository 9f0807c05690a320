"""Seeded avalanche hashing for set selection and fingerprints (torch).

Counterpart of ``repro/core/hashing.py``: the murmur3/xxhash 32-bit
finalizer pattern, bit-identical to the reference.  Keys travel through the
port as **int32 bit patterns** of the uint32 key (the layout the CUDA
kernels take), so ``EMPTY_KEY`` 0xFFFFFFFF is ``-1`` here.

Torch on the CPU has no ``+``, ``>>`` or ``minimum`` for ``uint32`` and its
int32 ``>>`` is arithmetic, so the hash runs in int64 masked to 32 bits.
Products of two 32-bit values would overflow int64, so each multiply is
split into two 16-bit halves (``_mul32``), every partial product < 2^48.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_PRIME1 = 0x9E3779B1
_PRIME2 = 0x85EBCA77

#: Sentinel for an empty way, as the uint32 value and as the int32 lane.
EMPTY_KEY = 0xFFFFFFFF
EMPTY = -1
#: ``sanitize_keys`` folds the sentinel onto 0xFFFFFFFE (int32 -2).
_FOLDED = -2


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def as_u32(keys: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 value."""
    return keys.to(torch.int64) & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def hash_u32(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded avalanche hash of uint32 keys (any integer dtype, read as its
    low 32 bits) -> int64 in [0, 2^32)."""
    k = as_u32(keys)
    h = _mul32((k + (seed * _PRIME1 & _M32)) & _M32, _PRIME2)
    return _fmix32(h)


def set_index(keys: torch.Tensor, num_sets: int, seed: int = 0x51CA) -> torch.Tensor:
    """Map keys to set indices (int64).  ``num_sets`` must be a power of
    two."""
    if num_sets & (num_sets - 1):
        raise ValueError("num_sets must be a power of two")
    return hash_u32(keys, seed) & (num_sets - 1)


def fingerprint(keys: torch.Tensor, seed: int = 0xF19E) -> torch.Tensor:
    """16-bit fingerprint of the SoA layout, as int32."""
    return (hash_u32(keys, seed) & 0xFFFF).to(torch.int32)


def sanitize_keys(keys: torch.Tensor) -> torch.Tensor:
    """int32 key lanes with the EMPTY sentinel folded onto 0xFFFFFFFE."""
    return torch.where(keys == EMPTY, torch.full_like(keys, _FOLDED), keys)


def key_tensor(keys, device) -> torch.Tensor:
    """uint32 keys (numpy array, Python ints or an integer tensor) -> the
    int32 bit-pattern tensor the port computes on, on ``device``."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype != torch.int32:
            keys = to_i32(as_u32(keys))
        return keys.to(device)
    arr = np.ascontiguousarray(np.asarray(keys, np.uint32).view(np.int32))
    return torch.from_numpy(arr).to(device)


def hash_u32_int(key: int, seed: int) -> int:
    """``hash_u32`` of one Python int (the sequential oracle's hash)."""
    x = ((key & _M32) + seed * _PRIME1) * _PRIME2 & _M32
    x ^= x >> 16
    x = x * _C1 & _M32
    x ^= x >> 13
    x = x * _C2 & _M32
    return x ^ (x >> 16)


# ---------------------------------------------------------------------------
# prefix-chain block hashing (serve/engine.py content addressing)
# ---------------------------------------------------------------------------

#: FNV-1a fold constants for the per-block digest.
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
#: Position salt multiplier (golden-ratio constant == xxhash PRIME32_1).
_GOLDEN = 0x9E3779B1


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on uint32 numpy arrays (bit-identical to
    ``_fmix32``)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_C1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_C2)
    return x ^ (x >> np.uint32(16))


def prefix_block_hashes(tokens: np.ndarray, page: int) -> np.ndarray:
    """Rolling prefix-chain hash per full block -> uint32 [len // page].

    ``block_hash[i]`` covers ``tokens[0 : (i+1)*page]``, so a block only
    matches when its whole prefix matches and a page hit guarantees
    identical KV.  Each block's tokens are folded with FNV-1a, the digest is
    mixed with its position, and the chain is the cumulative XOR.  The value
    0xFFFFFFFF (the EMPTY key) is replaced by 1.
    """
    n = len(tokens) // page
    if n == 0:
        return np.empty(0, np.uint32)
    blocks = np.asarray(tokens[: n * page], dtype=np.uint32).reshape(n, page)
    h = np.full(n, np.uint32(_FNV_OFFSET), np.uint32)
    with np.errstate(over="ignore"):
        for j in range(page):
            h = (h ^ blocks[:, j]) * np.uint32(_FNV_PRIME)
        salt = np.arange(1, n + 1, dtype=np.uint32) * np.uint32(_GOLDEN)
        out = np.bitwise_xor.accumulate(_fmix32_np(h ^ salt)).astype(np.uint32)
    out[out == np.uint32(EMPTY_KEY)] = np.uint32(1)
    return out


def prefix_block_hashes_t(tokens: torch.Tensor, page: int) -> torch.Tensor:
    """Device twin of ``prefix_block_hashes`` for fixed-width token lanes.

    ``tokens`` an integer tensor [..., n*page] (padded prompt lanes) ->
    int64 [..., n] chain hashes in [0, 2^32) over ALL n blocks.  The first
    ``len(prompt) // page`` of a lane are those of the numpy form (the
    chain is a prefix scan, so padding never reaches a real block); the
    caller masks the rest.  Fixed shapes and no host sync, so a CUDA graph
    can capture it: torch has no cumulative XOR, so the chain is
    ``log2(n)`` shift-and-XOR steps (an inclusive Hillis-Steele scan).
    """
    n = tokens.shape[-1] // page
    blocks = as_u32(tokens[..., : n * page]).reshape(*tokens.shape[:-1], n,
                                                     page)
    h = torch.full(blocks.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                   device=tokens.device)
    for j in range(page):
        h = _mul32(h ^ blocks[..., j], _FNV_PRIME)
    salt = _mul32(torch.arange(1, n + 1, dtype=torch.int64,
                               device=tokens.device), _GOLDEN)
    out = _fmix32(h ^ salt)
    shift = 1
    while shift < n:
        out = out ^ torch.nn.functional.pad(out[..., :-shift], (shift, 0))
        shift *= 2
    return torch.where(out == EMPTY_KEY, torch.ones_like(out), out)
