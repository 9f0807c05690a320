"""Batched k-way set probe: Hopper kernels 1 and 2 and their plain versions.

Replaces the Pallas TPU kernels of ``repro/kernels/kway_probe.py``
(``kway_probe`` and ``kway_fused_probe``) with hand-written CUDA in
``csrc/kway_probe.cu``; see that file for the design and its bound.  The
plain versions are ``kernels/ref.py``.

Each wrapper is one launch that takes the raw int32 key lanes and the
state's clock and routes the keys itself (sanitize, set index, times), and
returns every output as a view of one int32 buffer, in the dtypes
``core/kway.py``'s applies consume: sanitized keys int32, sets and ways
int64, hits bool.  A wrapper runs the plain version when its tensors lie
on the CPU, and on a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Widest set the kernels take (one row of 128 ways).
MAX_WAYS = 128
#: Most queries one call takes.
MAX_QUERIES = 2**24
#: Kernel 2's global scratch, in ints per query (``kScratchPerQuery``).
FUSED_SCRATCH = 15

LAUNCHES = {"kway_probe": 0, "kway_fused_probe": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: output layouts, by their number in csrc/kway_probe.cu
_HITS, _VICTIM, _ORDER, _FUSED = range(4)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a build of ``csrc/kway_probe.cu``: the
    library's, and ``kway_phase_clocks`` in a build with
    ``-DKWAY_PHASE_CLOCKS`` (kernel 2's phase stamps, for measurement)."""
    lib.kway_probe_launch.argtypes = [_P] * 6 + [_I] * 6 + [_P] * 2
    lib.kway_probe_launch.restype = _I
    lib.kway_fused_probe_launch.argtypes = [_P] * 7 + [_I] * 5 + [_P] * 2
    lib.kway_fused_probe_launch.restype = _I
    if hasattr(lib, "kway_phase_clocks"):
        lib.kway_phase_clocks.argtypes = [_P, _I]
        lib.kway_phase_clocks.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return declare(_build.library("kway_probe"))


def _i32(x: int) -> int:
    """A 32-bit value as the C int with the same bits."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _words(b: int, ways: int, mode: int) -> int:
    """int32 words of the output buffer (``layout`` in the C source), even
    so that the buffer views as int64."""
    victims = mode in (_VICTIM, _ORDER)
    words = (4 * b + 3 * b * victims + b + b * ways * (mode >= _ORDER)
             + (b + 3) // 4 + FUSED_SCRATCH * b * (mode == _FUSED))
    return words + (words & 1)


def _views(buf: torch.Tensor, b: int, ways: int, mode: int) -> tuple:
    """The outputs as views of ``buf``: (qk, sets, hit, way[, vway, vkey]
    [, order]).  ``as_strided`` makes each in one call (the host's time of
    a wrapper call is what the main path pays)."""
    victims = mode in (_VICTIM, _ORDER)
    i64 = buf.view(torch.int64)
    o = 6 * b if victims else 4 * b    # int32 words: sets, way[, vway]
    outs = (buf.as_strided((b,), (1,), o), i64.as_strided((b,), (1,), 0))
    way = i64.as_strided((b,), (1,), b)
    o += b
    rest = ()
    if victims:
        rest = (i64.as_strided((b,), (1,), 2 * b),
                buf.as_strided((b,), (1,), o))
        o += b
    if mode >= _ORDER:
        rest = rest + (buf.as_strided((b, ways), (ways, 1), o),)
        o += b * ways
    hit = buf.view(torch.bool).as_strided((b,), (1,), 4 * o)
    return outs + (hit, way) + rest


def _check(lanes, qkeys, clock, en):
    """Device, dtype, shape and contiguity checks before passing pointers."""
    s, ways = lanes[0].shape
    if not 1 <= ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}], got {ways}")
    dev = lanes[0].device
    for t in lanes:
        if (t.shape != (s, ways) or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError("state lanes must be contiguous int32 [S, ways] "
                             "on one device")
    b = qkeys.shape[0]
    if (qkeys.shape != (b,) or qkeys.dtype != torch.int32
            or qkeys.device != dev or not qkeys.is_contiguous()):
        raise ValueError("query keys must be contiguous int32 [B] on the "
                         "state's device")
    if not 1 <= b <= MAX_QUERIES:
        raise ValueError(f"queries must number 1 to {MAX_QUERIES}, got {b}")
    if (clock.numel() != 1 or clock.dtype != torch.int32
            or clock.device != dev):
        raise ValueError("clock must be one int32 on the state's device")
    if en is not None and (en.shape != (b,) or en.dtype != torch.bool
                           or en.device != dev or not en.is_contiguous()):
        raise ValueError("en must be contiguous bool [B] on the state's "
                         "device")
    return b, ways


def kway_probe(keys, fprint, meta_a, meta_b, qkeys, clock, *, num_sets,
               seed, policy, full_order=False, need_victims=True):
    """Route and probe B raw int32 key lanes ``qkeys`` against the state
    lanes (int32 [S, ways]) at times ``clock + i`` (``clock`` the state's
    int32 scalar): (qk int32, sets int64, hit bool, way int64) [B]; with
    ``need_victims`` also the victim way (int64) and key (int32) [B]; with
    ``full_order`` also the worst-victim-first order int32 [B, ways]."""
    if full_order and not need_victims:
        raise ValueError("full_order requires need_victims=True")
    if keys.device.type == "cpu":
        return _ref.kway_probe_ref(keys, fprint, meta_a, meta_b, qkeys,
                                   clock, num_sets=num_sets, seed=seed,
                                   policy=policy, full_order=full_order,
                                   need_victims=need_victims)
    if keys.device.type != "cuda":
        raise ValueError(f"no kway_probe kernel for device {keys.device}")
    b, ways = _check((keys, fprint, meta_a, meta_b), qkeys, clock, None)
    mode = _ORDER if full_order else int(need_victims)
    buf = torch.empty(_words(b, ways, mode), dtype=torch.int32,
                      device=keys.device)
    rc = _lib().kway_probe_launch(
        keys.data_ptr(), fprint.data_ptr(), meta_a.data_ptr(),
        meta_b.data_ptr(), qkeys.data_ptr(), clock.data_ptr(), num_sets,
        _i32(seed), b, ways, int(policy), mode, buf.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(rc, "kway_probe")
    LAUNCHES["kway_probe"] += 1
    return _views(buf, b, ways, mode)


def kway_fused_probe(keys, fprint, meta_a, meta_b, qkeys, clock, en, *,
                     num_sets, seed, policy):
    """Fused probe for ``access``: route B raw int32 key lanes ``qkeys``
    and probe at ``clock + i`` -> (qk int32, sets int64, hit bool [B] raw,
    way int64 [B], order int32 [B, ways]), the order scored at
    ``clock + B + i`` on ``meta_a`` after the live hits' on_hit (``en``
    bool [B]; None: every lane).  No input is written."""
    if keys.device.type == "cpu":
        return _ref.kway_fused_probe_ref(keys, fprint, meta_a, meta_b, qkeys,
                                         clock, en, num_sets=num_sets,
                                         seed=seed, policy=policy)
    if keys.device.type != "cuda":
        raise ValueError(f"no kway_fused_probe kernel for device "
                         f"{keys.device}")
    b, ways = _check((keys, fprint, meta_a, meta_b), qkeys, clock, en)
    buf = torch.empty(_words(b, ways, _FUSED), dtype=torch.int32,
                      device=keys.device)
    rc = _lib().kway_fused_probe_launch(
        keys.data_ptr(), fprint.data_ptr(), meta_a.data_ptr(),
        meta_b.data_ptr(), qkeys.data_ptr(),
        None if en is None else en.data_ptr(), clock.data_ptr(), num_sets,
        _i32(seed), b, ways, int(policy), buf.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(rc, "kway_fused_probe")
    LAUNCHES["kway_fused_probe"] += 1
    return _views(buf, b, ways, _FUSED)
