"""Paged GQA decode attention: Hopper kernel 5 and its plain version.

Replaces the Pallas TPU kernel of ``repro/kernels/paged_attention.py``
(``paged_attention``) with hand-written CUDA in
``csrc/paged_attention.cu``, a split-K flash decode; see that file for the
design and its bound.  The plain version is ``kernels/ref.py``
``paged_attention_ref``.

The wrapper runs the plain version when its tensors lie on the CPU, and on
CUDA tensors launches the kernel or raises.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 64, 80, 128, 256)
#: Page sizes the kernel takes (a lane keeps one token's score).
MAX_PAGE = 32
#: Query heads per KV head the kernel takes.
MAX_GROUP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Warps per CTA, and the shared memory their K/V rings may take.
_MAX_WARPS = 4
_RING_BYTES = 64 * 1024

LAUNCHES = {"paged_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    lib.paged_attention_launch.argtypes = ([_P] * 8 + [_I] * 11 + [_F] * 2
                                           + [_P])
    lib.paged_attention_launch.restype = _I
    return lib


def split_plan(page: int, d: int, itemsize: int, pps: int, b: int, kvh: int,
               sms: int) -> tuple[int, int, int]:
    """(warps per CTA W, pages per CTA, splits S) of one launch.

    From the shapes and the SM count only, never from ``seq_lens``: reading
    those on the host would sync the device in every decode step.  Each warp
    rings two pages of K and V through shared memory (W as large as 64 KiB of
    rings allow, at most 4); a CTA takes two pages per warp, fewer when the
    grid would hold under four CTAs per SM."""
    warp_bytes = 2 * 2 * page * d * itemsize
    w = max(1, min(_MAX_WARPS, _RING_BYTES // warp_bytes))
    ppc = 2 * w
    while ppc > 1 and b * kvh * -(-pps // ppc) < 4 * sms:
        ppc //= 2
    return w, ppc, -(-pps // ppc)


def _check_inputs(q, k_pages, v_pages, page_table, seq_lens):
    """Device, dtype, shape and contiguity checks before passing pointers."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, H, D] and the pools [KVH, P, page, D]")
    b, h, d = q.shape
    kvh, _, page, _ = k_pages.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError("q and the pools must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if k_pages.shape[3] != d or v_pages.shape != k_pages.shape \
            or h % kvh != 0:
        raise ValueError("pool shapes must be [KVH, P, page, D] with H a "
                         "multiple of KVH")
    if h // kvh > MAX_GROUP or not 1 <= page <= MAX_PAGE:
        raise ValueError(f"at most {MAX_GROUP} query heads per KV head and "
                         f"{MAX_PAGE} tokens per page; got {h // kvh}, {page}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError("page_table must be int32 [B, PPS]")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (b,):
        raise ValueError("seq_lens must be int32 [B]")
    for t in (q, k_pages, v_pages, page_table, seq_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")


#: Zeroed int32 tickets per (device, stream): each launch leaves its own
#: tickets at 0 again, so launches in one stream share them.
_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(device, stream)] = torch.zeros(n, dtype=torch.int32,
                                                     device=device)
    return t


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale: float | None = None, softcap: float = 0.0):
    """One decode step of paged GQA attention -> [B, H, D] in q's dtype.

    ``q`` [B, H, D]; ``k_pages`` / ``v_pages`` [KVH, P, page, D]
    (head-major pool, 16-byte aligned); ``page_table`` int32 [B, PPS];
    ``seq_lens`` int32 [B].  ``scale`` defaults to D^-0.5; ``softcap > 0``
    caps the logits with tanh.  The kernel reads only the pages below
    ``min(ceil(seq_len / page), PPS)``; page ids must lie in [0, P)."""
    if q.device.type == "cpu":
        return _ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                        seq_lens, scale=scale,
                                        softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}")
    _check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    kptr, vptr = k_pages.data_ptr(), v_pages.data_ptr()
    if (kptr | vptr) & 15:
        raise ValueError("the K/V pools must be 16-byte aligned")
    b, h, d = q.shape
    kvh, p, page, _ = k_pages.shape
    pps = page_table.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    w, ppc, s = split_plan(page, d, q.element_size(), pps, b, kvh, sms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    ws = torch.empty(b * kvh * s * (h // kvh) * (d + 2), dtype=torch.float32,
                     device=q.device)
    rc = _lib().paged_attention_launch(
        q.data_ptr(), kptr, vptr, page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(),
        _tickets(q.device, stream, b * kvh).data_ptr(),
        b, h, kvh, p, page, pps, d, _DTYPES[q.dtype], s, ppc, w,
        d ** -0.5 if scale is None else float(scale), float(softcap), stream)
    _build.check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
