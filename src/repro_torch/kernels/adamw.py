"""AdamW over every leaf: a hand-written CUDA pass and its plain version.

Replaces no Pallas kernel: the reference's ``update``
(``repro/optim/adamw.py:80``) is one XLA fusion per leaf under ``jit``.
``csrc/adamw.cu`` does the same work for all leaves at once in three
launches (the norm's partials, their fixed-order sum, the update); see that
file for the design and its bound.

Two ``torch.library`` ops take lists of plain (local) tensors:

    repro_torch::adamw_sumsq(grads) -> float32 0-d
        the sum of every gradient's float32 squares;
    repro_torch::adamw_step_(grads, m, v, master, params, scale, lr, bc1,
                             bc2, b1, b2, eps, weight_decay)
        one AdamW step of every leaf in place (m, v, master and params are
        written; a gradient of None is a zero gradient, a parameter of None
        is left to the caller).

Their CPU implementations are the plain versions (``sumsq_plain``,
``adamw_step_plain``: the eager arithmetic, leaf by leaf); their CUDA
implementations launch the kernels or raise, never the plain version;
their fake implementations allocate only the norm's 0-d result, so a dry
run under ``FakeTensorMode`` meets one op per pass and no temporaries.
``LAUNCHES`` counts the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

#: blocks of the fixed grid, per SM (the norm's bits depend on the grid)
BLOCKS_PER_SM = 4
#: elements of a leaf one block takes at a time (a multiple of the
#: kernels' 256 threads x 4 elements)
CHUNK = 16384
_DTYPES = {torch.float32: 1, torch.bfloat16: 2}

LAUNCHES = {"adamw": 0, "adamw_sumsq": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("adamw")
    lib.adamw_sumsq_launch.argtypes = [_P, _I, _L, _I, _I, _P, _P, _P]
    lib.adamw_sumsq_launch.restype = _I
    lib.adamw_update_launch.argtypes = [_P, _I, _L, _I, _I] + [_P] * 4 \
        + [_F] * 6 + [_P]
    lib.adamw_update_launch.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sumsq_plain(grads) -> torch.Tensor:
    """Sum of every gradient's float32 squares, leaf by leaf in order."""
    total = None
    for g in grads:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return total


def adamw_step_plain(grads, m, v, master, params, scale, lr, bc1, bc2,
                     b1: float, b2: float, eps: float,
                     weight_decay: float) -> None:
    """One AdamW step of each leaf in place, each line the reference's
    expression rounded in the same order:
        m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        master = master - lr * ((m / bc1) / (sqrt(v / bc2) + eps)
                                + weight_decay * master)
    then the parameter (where not None) takes its master in its dtype."""
    for g, mm, vv, w, p in zip(grads, m, v, master, params):
        g = torch.zeros_like(w) if g is None else \
            g.to(torch.float32, copy=True)
        g.mul_(scale)
        mm.mul_(b1).add_(g * (1 - b1))
        vv.mul_(b2).add_((g * (1 - b2)).mul_(g))
        upd = (mm / bc1).div_((vv / bc2).sqrt_().add_(eps))
        upd.add_(w * weight_decay)
        w.sub_(upd.mul_(lr))
        if p is not None:
            p.copy_(w)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_leaf(i, g, m, v, w, p, dev):
    for name, t in (("m", m), ("v", v), ("master", w)):
        if t.dtype != torch.float32:
            raise ValueError(f"leaf {i}: {name} must be float32, got "
                             f"{t.dtype}")
    for name, t in (("grad", g), ("m", m), ("v", v), ("master", w),
                    ("param", p)):
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"leaf {i}: {name} must be contiguous on {dev}")
        if t.numel() != w.numel():
            raise ValueError(f"leaf {i}: {name} has {t.numel()} elements, "
                             f"master {w.numel()}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"leaf {i}: {name} dtype {t.dtype} is neither "
                             "float32 nor bfloat16")


def table_rows(leaves, ptr=lambda t: t.data_ptr()) -> tuple[list, int]:
    """The rows of ``csrc/adamw.cu``'s leaf table, flattened: 8 int64 a
    leaf of nonzero size (addresses of g, m, v, w and p, elements, first
    chunk, flags: g's dtype, p's dtype << 8, all addresses 16-byte aligned
    << 16) -> (rows, chunks).  ``leaves``: (g, m, v, w, p) with None where
    absent (address 0, dtype 0); ``ptr`` gives a tensor's address."""
    rows, chunks = [], 0
    for g, m, v, w, p in leaves:
        n = w.numel()
        if n == 0:
            continue
        ptrs = [0 if t is None else ptr(t) for t in (g, m, v, w, p)]
        flags = ((0 if g is None else _DTYPES[g.dtype])
                 | (0 if p is None else _DTYPES[p.dtype]) << 8
                 | int(all(a % 16 == 0 for a in ptrs)) << 16)
        rows += ptrs + [n, chunks, flags]
        chunks += -(-n // CHUNK)
    return rows, chunks


def _table(leaves, dev) -> tuple[torch.Tensor, int, int]:
    """The leaf table on ``dev`` -> (table, rows, chunks), copied from
    pinned memory without a host sync."""
    rows, chunks = table_rows(leaves)
    table = torch.tensor(rows or [0], dtype=torch.int64).pin_memory()
    return table.to(dev, non_blocking=True), len(rows) // 8, chunks


def _blocks(dev, chunks: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(chunks, BLOCKS_PER_SM * sms))


def _scalar(t: torch.Tensor, name: str, dev) -> int:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name} must be one float32 on {dev}")
    return t.data_ptr()


def sumsq_cuda(grads) -> torch.Tensor:
    """The norm's pass on CUDA tensors: two launches, the same bits on
    every run."""
    dev = grads[0].device
    for i, g in enumerate(grads):
        if g.device != dev or not g.is_contiguous() \
                or g.dtype not in _DTYPES:
            raise ValueError(f"gradient {i}: contiguous float32 or bfloat16 "
                             f"on {dev}, got {g.dtype} on {g.device}")
    # a row per gradient: the kernel reads g and the count (w's slot)
    table, n, chunks = _table([(g, None, None, g, None) for g in grads], dev)
    blocks = _blocks(dev, chunks)
    partials = torch.empty(blocks, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib().adamw_sumsq_launch(
        table.data_ptr(), n, chunks, CHUNK, blocks, partials.data_ptr(),
        out.data_ptr(), stream), "adamw_sumsq")
    LAUNCHES["adamw_sumsq"] += 1
    return out


def adamw_step_cuda(grads, m, v, master, params, scale, lr, bc1, bc2,
                    b1, b2, eps, weight_decay) -> None:
    """The update's pass on CUDA tensors: one launch over every leaf."""
    dev = master[0].device
    leaves = list(zip(grads, m, v, master, params))
    for i, leaf in enumerate(leaves):
        _check_leaf(i, *leaf, dev)
    ptrs = [_scalar(t, k, dev) for t, k in ((scale, "scale"), (lr, "lr"),
                                            (bc1, "bc1"), (bc2, "bc2"))]
    table, n, chunks = _table(leaves, dev)
    if chunks == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib().adamw_update_launch(
        table.data_ptr(), n, chunks, CHUNK, _blocks(dev, chunks), *ptrs, b1,
        1 - b1, b2, 1 - b2, eps, weight_decay, stream), "adamw_update")
    LAUNCHES["adamw"] += 1


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::adamw_sumsq", mutates_args=(),
                         device_types="cpu")
def sumsq(grads: list[torch.Tensor]) -> torch.Tensor:
    """Sum of every gradient's float32 squares (a non-empty list)."""
    return sumsq_plain(grads)


sumsq.register_kernel("cuda")(sumsq_cuda)


@sumsq.register_fake
def _sumsq_fake(grads):
    return grads[0].new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_step_",
                         mutates_args=("m", "v", "master", "params"),
                         device_types="cpu")
def adamw_step_(grads: list[Optional[torch.Tensor]], m: list[torch.Tensor],
                v: list[torch.Tensor], master: list[torch.Tensor],
                params: list[Optional[torch.Tensor]], scale: torch.Tensor,
                lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                b1: float, b2: float, eps: float,
                weight_decay: float) -> None:
    """One AdamW step of every leaf in place (see ``adamw_step_plain``)."""
    adamw_step_plain(grads, m, v, master, params, scale, lr, bc1, bc2, b1,
                     b2, eps, weight_decay)


adamw_step_.register_kernel("cuda")(adamw_step_cuda)


@adamw_step_.register_fake
def _adamw_step_fake(grads, m, v, master, params, scale, lr, bc1, bc2, b1,
                     b2, eps, weight_decay):
    return None
