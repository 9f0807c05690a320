"""serve_mfu: the model FLOPs of the work the prefix cache leaves, over the
window's seconds, as a share of the card's bf16 peak.

The work: each request admitted in the window, its prompt tokens after its
prefix hits; every token a decode step consumed in the window; and the
logits of every token emitted in the window.  A token at position p costs
2 x the non-embedding parameters plus the attention over its p + 1
positions (QK and PV: 4 x heads x head_dim x (p + 1) a layer); an emitted
token costs 2 x d x vocab more.  Counted from the configuration's shapes,
however the program computes them.  Where the profiler started inside the
window (a traced run that traces the window's last seconds), the seconds
it took to start are left out of the window's."""
from bench.peaks import peak


def params(s: dict) -> int:
    """Non-embedding parameters: attention, gated MLP, norms."""
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    per = 2 * s["d"] * q + 2 * s["d"] * kv + 3 * s["d"] * s["ff"] \
        + 2 * s["d"]
    return s["layers"] * per + s["d"]


def token_flops(s: dict, pos: int) -> int:
    return 2 * params(s) + 4 * s["heads"] * s["head_dim"] * (pos + 1) \
        * s["layers"]


def prompt_flops(s: dict, n: int, first: int) -> int:
    """Tokens first..n-1 of a prompt, in closed form."""
    k = n - first
    att = 4 * s["heads"] * s["head_dim"] * s["layers"]
    return k * 2 * params(s) + att * (n * (n + 1) - first * (first + 1)) // 2


def window_flops(r: dict) -> int:
    s, page = r["shape"], r["page"]
    total = 0
    for rec in r["recs"].values():
        if rec.admitted_in_window:
            total += prompt_flops(s, len(rec.prompt),
                                  rec.req.prefix_hits * page)
    for rid, a, b in r["emitted"]:
        n = len(r["recs"][rid].prompt)
        for j in range(a, b):
            total += 2 * s["d"] * s["vocab"]
            if j >= 1:
                total += token_flops(s, n + j - 1)
    return total


def read(run):
    p = peak(run.kind, "bf16_flop_s")
    if p is None or "emitted" not in run.records or run.window_s <= 0:
        return None
    seconds = run.window_s - run.records.get("trace_start_s", 0.0)
    return 100.0 * window_flops(run.records) / seconds / p
