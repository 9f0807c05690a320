"""Paged GQA decode attention: Hopper kernel 5 and its plain version.

Replaces the Pallas TPU kernel of ``repro/kernels/paged_attention.py``
(``paged_attention``) with hand-written CUDA in
``csrc/paged_attention.cu``; see that file for the design and its bound.
The plain version is ``kernels/ref.py`` ``paged_attention_ref``.

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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"paged_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    lib.paged_attention_launch.argtypes = [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P]
    lib.paged_attention_launch.restype = _I
    return lib


def _check_inputs(q, k_pages, v_pages, page_table, seq_lens):
    """Device, dtype, shape and contiguity checks before passing pointers."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, H, D] and the pools [KVH, P, page, D]")
    b, h, d = q.shape
    kvh = k_pages.shape[0]
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
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError("page_table must be int32 [B, PPS]")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (b,):
        raise ValueError("seq_lens must be int32 [B]")
    for t in (q, k_pages, v_pages, page_table, seq_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale: float | None = None, softcap: float = 0.0):
    """One decode step of paged GQA attention -> [B, H, D] in q's dtype.

    ``q`` [B, H, D]; ``k_pages`` / ``v_pages`` [KVH, P, page, D]
    (head-major pool); ``page_table`` int32 [B, PPS]; ``seq_lens`` int32
    [B].  ``scale`` defaults to D^-0.5; ``softcap > 0`` caps the logits
    with tanh.  The kernel reads only the pages below ``ceil(seq_len /
    page)``; page ids must lie in [0, P)."""
    if q.device.type == "cpu":
        return _ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                        seq_lens, scale=scale,
                                        softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}")
    _check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    b, h, d = q.shape
    kvh, p, page, _ = k_pages.shape
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    rc = _lib().paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, h,
        kvh, p, page, page_table.shape[1], d, _DTYPES[q.dtype], scale,
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
