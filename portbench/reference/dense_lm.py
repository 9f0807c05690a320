"""Plain float32 forward of a dense decoder-only transformer of the Llama
layout (DeepSeek LLM 7B, arXiv:2401.02954): the yardstick of the serving
cells, and its fp8 control.

Each layer: x += Wo . attn(RoPE(Wq h), RoPE(Wk h), Wv h) with h = RMSNorm(x),
causal softmax at scale head_dim**-0.5; then x += W2 (silu(Wg h) * (Wi h))
with h = RMSNorm(x).  RMSNorm scales by ``1 + w`` (w stored as an offset, as
the benchmark draws it: zeros); RoPE rotates the two halves of each head
(frequencies theta**(-i / (D/2))).  The logits are RMSNorm(x) . W_head.

Everything runs in float32 with TF32 off (``exact_float32``), layer by
layer over a padded block of sequences, from the same bf16 weights the
benchmark hands the program (each layer's weights widened to float32 while
it runs).  It imports nothing of the program.

``fp8=True`` is the control: every linear layer's weights (per output
column) and inputs (per row) rounded to float8 e4m3 with a float32 scale,
the step below the bf16 that the configuration serves in.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products in float32, not TF32, while open."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one float32 scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [..., din] @ w [din, dout] in float32 (fp8-rounded operands when
    ``fp8``)."""
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, D] at positions 0..T-1."""
    t, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(x: torch.Tensor, w: dict, cfg: dict, fp8: bool) -> torch.Tensor:
    """One block over x float32 [B, T, d]; ``w`` the layer's float32
    weights."""
    b, t, _ = x.shape
    nh, kvh, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    h = rms_norm(x, w["ln1"], cfg["eps"])
    q = rope(_linear(h, w["wq"], fp8).view(b, t, nh, hd), cfg["theta"])
    k = rope(_linear(h, w["wk"], fp8).view(b, t, kvh, hd), cfg["theta"])
    v = _linear(h, w["wv"], fp8).view(b, t, kvh, hd)
    rep = nh // kvh
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * hd ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = torch.einsum("bhts,bshd->bthd", s, v).reshape(b, t, nh * hd)
    del s
    x = x + _linear(o, w["wo"], fp8)
    h = rms_norm(x, w["ln2"], cfg["eps"])
    g = _linear(h, w["wg"], fp8)
    a = g * torch.sigmoid(g) * _linear(h, w["wi"], fp8)
    return x + _linear(a, w["w2"], fp8)


def logits_at(weights: dict, cfg: dict, seqs: list, positions: list,
              *, fp8: bool = False, device=None) -> list:
    """float32 logits [len(p), V] of each sequence in ``seqs`` (int token
    lists) at the positions ``positions[i]`` (the logits there predict the
    next token).

    ``weights``: ``embed`` [V, d], ``head`` [d, V], ``final_norm`` [d] and
    per layer stacked ``ln1``, ``ln2`` [L, d], ``wq`` [L, d, H*D], ``wk``,
    ``wv`` [L, d, KVH*D], ``wo`` [L, H*D, d], ``wi``, ``wg`` [L, d, F],
    ``w2`` [L, F, d], in any dtype; ``cfg``: ``layers``, ``heads``,
    ``kv_heads``, ``head_dim``, ``eps``, ``theta``."""
    dev = device or weights["embed"].device
    t = max(len(s) for s in seqs)
    tok = torch.zeros((len(seqs), t), dtype=torch.long)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.long)
    tok = tok.to(dev)
    leaves = ("ln1", "ln2", "wq", "wk", "wv", "wo", "wi", "wg", "w2")
    with exact_float32(), torch.no_grad():
        x = weights["embed"][tok].float()
        for li in range(cfg["layers"]):
            w = {k: weights[k][li].to(dev).float() for k in leaves}
            x = layer(x, w, cfg, fp8)
            del w
        head = weights["head"].to(dev).float()
        out = []
        for i, pos in enumerate(positions):
            h = rms_norm(x[i, list(pos)], weights["final_norm"].to(
                dev).float(), cfg["eps"])
            out.append(_linear(h, head, fp8))
        return out
