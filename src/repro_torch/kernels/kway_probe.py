"""Batched k-way set probe: Hopper kernels 1 and 2 and their plain versions.

Replaces the Pallas TPU kernels of ``repro/kernels/kway_probe.py``
(``kway_probe`` and ``kway_fused_probe``) with hand-written CUDA in
``csrc/kway_probe.cu``; see that file for the design and its bound.  The
plain versions are ``kernels/ref.py``.

A wrapper runs the plain version when its tensors lie on the CPU, and on a
CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per wrapper (the fused probe's two launches count once: together
they are the port of one TPU kernel).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.policies import Policy
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Widest set the kernels take (one row of 128 ways).
MAX_WAYS = 128

LAUNCHES = {"kway_probe": 0, "kway_fused_probe": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("kway_probe")
    lib.kway_probe_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P] * 6
    lib.kway_probe_launch.restype = _I
    lib.kway_fused_probe_launch.argtypes = [_P] * 9 + [_I] * 3 + [_P] * 4
    lib.kway_fused_probe_launch.restype = _I
    return lib


def _check_inputs(lanes, vecs, b):
    """Device, dtype, shape and contiguity checks before passing pointers."""
    s, ways = lanes[0].shape
    if not 1 <= ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}], got {ways}")
    dev = lanes[0].device
    for t in lanes:
        if t.shape != (s, ways) or t.dtype != torch.int32:
            raise ValueError("state lanes must be int32 [S, ways]")
    for t in vecs:
        if t.shape != (b,) or t.dtype not in (torch.int32, torch.bool):
            raise ValueError("query vectors must be int32/bool [B]")
    for t in (*lanes, *vecs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")


def kway_probe(keys, fprint, meta_a, meta_b, sets, qkeys, times, *, policy,
               full_order=False, need_victims=True):
    """Probe B queries: (hit, way) int32 [B]; with ``need_victims`` also the
    victim way and key scored at ``times``; with ``full_order`` also the
    worst-victim-first order int32 [B, ways].  ``sets``, ``qkeys`` and
    ``times`` are int32 [B] (keys sanitized)."""
    if full_order and not need_victims:
        raise ValueError("full_order requires need_victims=True")
    if keys.device.type == "cpu":
        return _ref.kway_probe_ref(keys, fprint, meta_a, meta_b, sets, qkeys,
                                   times, policy=policy,
                                   full_order=full_order,
                                   need_victims=need_victims)
    if keys.device.type != "cuda":
        raise ValueError(f"no kway_probe kernel for device {keys.device}")
    b = sets.shape[0]
    _check_inputs((keys, fprint, meta_a, meta_b), (sets, qkeys, times), b)
    ways = keys.shape[1]

    def out(*shape):
        return torch.empty(shape, dtype=torch.int32, device=keys.device)

    hit, way = out(b), out(b)
    vway, vkey = (out(b), out(b)) if need_victims else (None, None)
    order = out(b, ways) if full_order else None
    mode = 2 if full_order else int(need_victims)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _lib().kway_probe_launch(
        ptr(keys), ptr(fprint), ptr(meta_a), ptr(meta_b), ptr(sets),
        ptr(qkeys), ptr(times), b, ways, int(policy), mode, ptr(hit),
        ptr(way), ptr(vway), ptr(vkey), ptr(order),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(rc, "kway_probe")
    LAUNCHES["kway_probe"] += 1
    outs = (hit, way)
    if need_victims:
        outs = outs + (vway, vkey)
    if full_order:
        outs = outs + (order,)
    return outs


def kway_fused_probe(keys, fprint, meta_a, meta_b, sets, qkeys, times_get,
                     times_put, en, *, policy):
    """Fused probe for ``access``: (hit int32 [B] raw, way int32 [B], order
    int32 [B, ways]) with the order scored at ``times_put`` on ``meta_a``
    after the live hits' (``en``) on_hit.  ``en`` is bool [B]."""
    if keys.device.type == "cpu":
        return _ref.kway_fused_probe_ref(keys, fprint, meta_a, meta_b, sets,
                                         qkeys, times_get, times_put, en,
                                         policy=policy)
    if keys.device.type != "cuda":
        raise ValueError(f"no kway_fused_probe kernel for device {keys.device}")
    b = sets.shape[0]
    en = en.to(torch.bool)
    _check_inputs((keys, fprint, meta_a, meta_b),
                  (sets, qkeys, times_get, times_put, en), b)
    ways = keys.shape[1]
    # the hit phase writes a copy of meta_a; FIFO/RANDOM have no on_hit
    no_hit_update = policy in (Policy.FIFO, Policy.RANDOM)
    ma1 = meta_a if no_hit_update else meta_a.clone()
    hit = torch.empty(b, dtype=torch.int32, device=keys.device)
    way = torch.empty_like(hit)
    order = torch.empty((b, ways), dtype=torch.int32, device=keys.device)
    rc = _lib().kway_fused_probe_launch(
        keys.data_ptr(), fprint.data_ptr(), ma1.data_ptr(),
        meta_b.data_ptr(), sets.data_ptr(), qkeys.data_ptr(),
        times_get.data_ptr(), times_put.data_ptr(), en.data_ptr(), b, ways,
        int(policy), hit.data_ptr(), way.data_ptr(), order.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(rc, "kway_fused_probe")
    LAUNCHES["kway_fused_probe"] += 1
    return hit, way, order
