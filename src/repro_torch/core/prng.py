"""Counter-based random draws of the serving sampler (torch).

The reference samples with ``jax.random``: a threefry-2x32 key from
``PRNGKey(seed)``, ``fold_in`` of the decode-step counter, then
``categorical``, the Gumbel-max draw over uniforms made from
``random_bits``.  These are the same functions, word for word, on torch
tensors, so the port draws the reference's tokens:

  * ``threefry2x32`` is the 20-round Threefry-2x32 hash;
  * ``fold_in(key, data)`` hashes the counter pair (0, data) under ``key``;
  * ``random_bits(key, shape)`` is JAX's partitionable form
    (``jax_threefry_partitionable``, the default since JAX 0.5): element i
    of the row-major flattening hashes the counter pair (i >> 32, i & M)
    and the two output words are XORed;
  * ``uniform`` keeps 23 bits as a float32 mantissa in [1, 2), minus 1,
    floored at the smallest normal float, as ``jax.random.uniform(minval=
    tiny)`` does; ``gumbel`` is ``-log(-log(u))``;
  * ``categorical`` is ``argmax(gumbel + logits)``, ties to the first.

Torch has no unsigned 32-bit arithmetic on every device, so the words are
int64 masked to 32 bits.  Every function is tensor ops with no host sync:
the serving tick draws inside a CUDA graph, keyed on a device counter.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k0, k1):
    int64 tensors (or ints) holding 32-bit values, broadcast together ->
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    for any integer seed in [-2^63, 2^63) the words (0, seed mod 2^32), as
    ints (no device copy, so a captured graph may fold into it); outside
    that range OverflowError, as JAX raises."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return (0, seed & _M32)


def fold_in(key, data, device=None) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` two words (ints or an int64 tensor
    [2]), ``data`` an int or a 0-d integer tensor, taken as uint32 -> the
    new key, int64 [2] on ``data``'s device (an int's on ``device``)."""
    data = torch.as_tensor(data, device=device).to(torch.int64) & _M32
    o0, o1 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([o0, o1])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 values in [0, 2^32)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (o0 ^ o1).reshape(shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``,
    the uniform the reference's Gumbel draw reads: float32 in [tiny, 1)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    # (maxval - minval) is 1.0 in float32
    return torch.clamp_min(floats * 1.0 + tiny, tiny)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``: -log(-log(u))."""
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` on float32 logits
    -> int64 indices, one per row."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
