"""k5_roofline: kernel 5's (paged decode attention's) share of its bound,
in the serving cells.

One call per layer and decode step over the engine's ``max_batch`` lanes.
Its bytes: each active sequence's K and V rows read once (2 x kv_heads x
head_dim x 2 B a position, over the position just written and all before
it), its page-table entries (4 B a page in use), q read and the output
written for every lane (2 x heads x head_dim x 2 B a lane) and the lengths
(4 B a lane); its operations 4 x heads x head_dim a position.  The bound is
the larger of bytes at the HBM rate and operations at the bf16 rate, summed
over the window's calls, over kernel 5's device time
(``paged_attention_kernel``), both over the steps traced
(``traced_from``: the first traced step and the emitted tokens before
it).  Not measured where the trace holds another number of kernel-5
records than those steps made calls."""
from bench.peaks import peak

KERNEL = "paged_attention_kernel"


def read(run):
    tl, r = run.timeline, run.records
    bw, fl = peak(run.kind, "hbm_byte_s"), peak(run.kind, "bf16_flop_s")
    if tl is None or bw is None or r.get("traced_from") is None:
        return None
    first, first_emitted = r["traced_from"]
    s, page, b = r["shape"], r["page"], r["max_batch"]
    calls = s["layers"] * r["decode_block"] * (len(r["steps"]) - first)
    if tl.count(KERNEL) != calls or not calls:
        return None
    hd, kvh, h = s["head_dim"], s["kv_heads"], s["heads"]
    nbytes = calls * (2 * b * h * hd * 2 + 4 * b)
    ops = 0
    for rid, a, e in r["emitted"][first_emitted:]:
        n = len(r["recs"][rid].prompt)
        for j in range(max(a, 1), e):
            seq = n + j
            nbytes += s["layers"] * (2 * kvh * hd * 2 * seq
                                     + 4 * (-(-seq // page)))
            ops += s["layers"] * 4 * h * hd * seq
    bound_s = max(nbytes / bw, ops / fl)
    return 100.0 * bound_s / tl.seconds(KERNEL)
