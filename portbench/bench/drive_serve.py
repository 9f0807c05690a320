"""Driver of the serving mixes: closed-loop clients through the program's
serving engine (``Engine.submit`` / ``Engine.step`` with ``jitted=True``:
the admit and decode CUDA graphs of the device-resident tick).

Configuration: the model's published sizes (Hugging Face keys) and the
engine's settings (``engine``).  Traffic parameters (``gen.RequestStream``):
``clients``, the prompt's parts, ``max_new``; ``prime`` sends one turn of
each session in set-up, as the cache state the mix lives in.

The weights are drawn from the seed on the card, one stacked tensor per
kind of leaf, and handed to both the program and the reference.  Held to
the reference after the window: every admission's prefix hits (the plain
k-way cache replays every prefix transaction the engine made, in the
order its requests and counters show) and its evictions, and the tokens that a sample of the finished
requests was served (their logits' gap below the float32 forward's best;
decode tokens read the K/V of blocks that earlier requests wrote, so a
wrong hit or page shows there).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import gen, limits
from bench.trace import Tracer
from reference import dense_lm
from reference import kway as kref

#: the logit gap of a window that finished no request
NOTHING = 1e30


def shapes(c: dict) -> dict:
    """Sizes of the model in the reference's names, from the published
    (Hugging Face) keys."""
    heads = c["num_attention_heads"]
    return dict(layers=c["num_hidden_layers"], d=c["hidden_size"],
                heads=heads, kv_heads=c["num_key_value_heads"],
                head_dim=c["hidden_size"] // heads,
                ff=c["intermediate_size"], vocab=c["vocab_size"],
                eps=c["rms_norm_eps"], theta=c["rope_theta"])


def draw_weights(c: dict, seed: int, device) -> dict:
    """bf16 weights, normal times fan_in**-0.5, one draw a kind of leaf
    stacked over the layers; norm offsets zero (float32)."""
    s = shapes(c)
    g = gen.generator(seed, device, 2)
    nl, d, hd = s["layers"], s["d"], s["head_dim"]
    q, kv, ff, v = s["heads"] * hd, s["kv_heads"] * hd, s["ff"], s["vocab"]

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device)
        return w.mul_(fan_in ** -0.5).to(torch.bfloat16)

    w = {"wq": normal((nl, d, q), d), "wk": normal((nl, d, kv), d),
         "wv": normal((nl, d, kv), d), "wo": normal((nl, q, d), q),
         "wi": normal((nl, d, ff), d), "wg": normal((nl, d, ff), d),
         "w2": normal((nl, ff, d), ff), "embed": normal((v, d), d),
         "head": normal((d, v), d)}
    zeros = dict(dtype=torch.float32, device=device)
    w.update(ln1=torch.zeros((nl, d), **zeros),
             ln2=torch.zeros((nl, d), **zeros),
             final_norm=torch.zeros(d, **zeros))
    return w


def program_model(name: str, c: dict, w: dict):
    """The program's ModelConfig and LM over the benchmark's weights."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import lm
    s = shapes(c)
    cfg = ModelConfig(name=name, family="dense", num_layers=s["layers"],
                      d_model=s["d"], num_heads=s["heads"],
                      num_kv_heads=s["kv_heads"], d_ff=s["ff"],
                      vocab_size=s["vocab"], head_dim=s["head_dim"],
                      rope_theta=s["theta"], norm_eps=s["eps"],
                      tie_embeddings=c.get("tie_word_embeddings", False))
    if lm.padded_vocab(cfg) != s["vocab"]:
        raise ValueError("the vocabulary must be a multiple of the "
                         "program's padding")
    blocks = [{"ln1": w["ln1"][i], "ln2": w["ln2"][i],
               "attn": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
               "mlp": {"wi": w["wi"][i], "wg": w["wg"][i],
                       "wo": w["w2"][i]}} for i in range(s["layers"])]
    return cfg, lm.LM(cfg, {"blocks": blocks, "embed": w["embed"],
                            "final_norm": w["final_norm"],
                            "lm_head": w["head"]})


@dataclasses.dataclass
class Rec:
    """One request as the harness sees it."""

    rid: int
    prompt: np.ndarray
    req: object              # the engine's Request
    submit_t: float
    first_t: float = None
    seen: int = 0            # tokens already counted
    admitted_in_window: bool = False


class Cell:
    def __init__(self, run):
        self.run = run
        self.attempted = 0
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.core.policies import Policy
        from repro_torch.serve import engine as E
        run, c, t = self.run, self.run.config, self.run.traffic
        self.shape = shapes(c)
        self.weights = draw_weights(c, run.seed, run.device)
        self.mcfg, model = program_model(run.workload["config"], c,
                                         self.weights)
        e = dict(c["engine"])
        e["policy"] = Policy.parse(e["policy"])
        self.ecfg = E.EngineConfig(jitted=True, **e)
        self.eng = E.Engine(self.mcfg, model, self.ecfg, device=run.device)
        self.stream = gen.RequestStream(t, self.shape["vocab"], run.seed)
        self.recs = {}
        # per admit tick: its transactions in order, each (rid, refused),
        # and the prefix hits of its refused lanes
        self.admit_txs, self.unknown = [], 0
        self._stats = self.eng.stats
        for prompt, max_new in self.stream.prime():
            self._submit(prompt, max_new)
        if not self.eng.waiting:
            # no priming: one request walks both graphs once
            self._submit(self.stream.request(-1)[0], self.ecfg.decode_block)
        while self.eng.waiting or self.eng.running:
            self._step(Tracer(False))
        self.stats0 = self.eng.stats

    def _submit(self, prompt, max_new) -> Rec:
        rid = self.eng.submit(prompt, max_new=max_new)
        req = self.eng.waiting[-1]
        rec = Rec(rid, prompt, req, time.perf_counter())
        self.recs[rid] = rec
        return rec

    def _step(self, tr) -> tuple:
        """One engine step; an admit tick's prefix transactions are
        appended to ``admit_txs`` -> (kind, seconds)."""
        eng = self.eng
        staged = list(eng.waiting[:self.ecfg.max_batch])
        admits = eng.ticks["admit"]
        tr.poll()
        t0 = time.perf_counter()
        with tr.span("step"):
            eng.step()
        dt = time.perf_counter() - t0
        kind = "admit" if eng.ticks["admit"] > admits else "decode"
        if kind == "admit":
            self._transactions_of(staged)
        return kind, dt

    def _transactions_of(self, staged: list) -> None:
        """The prefix transactions of one admit tick, in the engine's lane
        order (its queue order), from what the engine exposes: each
        admitted request's ``prefix_lookups`` and ``prefix_hits``, and the
        step's change of ``Engine.stats``.  Lookups the admitted requests
        do not account for are the transactions of lanes that ran and were
        refused: the first not admitted, in queue order, whose blocks make
        them up.  Where none do, the tick's sequence is unknown."""
        st = self.eng.stats
        d_look = st["prefix_lookups"] - self._stats["prefix_lookups"]
        d_hits = st["prefix_hits"] - self._stats["prefix_hits"]
        self._stats = st
        still = {id(r) for r in self.eng.waiting}
        ran = [r for r in staged if id(r) not in still]
        extra = d_look - sum(r.prefix_lookups for r in ran)
        refused = []
        for r in staged:
            if extra <= 0:
                break
            if id(r) in still:
                refused.append(r)
                extra -= self._lookups(r)
        if extra:
            self.unknown += 1
            from bench.main import say
            say(f"transaction sequence unknown: an admit tick's "
                f"{d_look} prefix lookups are not those of the requests "
                f"it staged")
        gone = {id(r) for r in refused}
        self.admit_txs.append((
            [(r.rid, id(r) in gone) for r in staged
             if id(r) in gone or id(r) not in still],
            d_hits - sum(r.prefix_hits for r in ran)))

    def _lookups(self, req) -> int:
        """The blocks a request's prefix transaction looks up."""
        return len(req.prompt) // self.ecfg.page

    # ------------------------------------------------------------ window
    def window(self, tr):
        run, t = self.run, self.run.traffic
        k = 0
        clients = []
        for _ in range(t["clients"]):
            clients.append(self._submit(*self.stream.request(k)))
            k += 1
        steps, ttft = [], []
        self.emitted = []           # (rid, first index, end index)
        tokens = 0
        t0 = time.perf_counter()
        traced_from = None          # (first traced step, its emitted)
        while True:
            n_emitted = len(self.emitted)
            kind, dt = self._step(tr)
            t1 = time.perf_counter()
            steps.append((kind, dt))
            if traced_from is None and tr.started:
                traced_from = (len(steps) - 1, n_emitted)
            for i, rec in enumerate(clients):
                n = len(rec.req.generated)
                if n and rec.first_t is None:
                    rec.first_t = t1
                    rec.admitted_in_window = True
                    ttft.append(t1 - rec.submit_t)
                if n > rec.seen:
                    self.emitted.append((rec.rid, rec.seen, n))
                    tokens += n - rec.seen
                    rec.seen = n
                if rec.req.done:
                    clients[i] = self._submit(*self.stream.request(k))
                    k += 1
            if t1 - t0 >= run.seconds:
                break
        run.window_s = t1 - t0
        self.tokens, self.ttft = tokens, np.array(ttft)
        self.attempted = k
        self.done = [r for r in self.recs.values()
                     if r.admitted_in_window and r.req.done]
        stats1 = self.eng.stats
        run.records.update(
            steps=steps, stats0=self.stats0, stats1=stats1, ttft=self.ttft,
            traced_from=traced_from,
            emitted=self.emitted, recs=self.recs, page=self.ecfg.page,
            decode_block=self.ecfg.decode_block,
            max_batch=self.ecfg.max_batch, shape=self.shape)
        self.evictions = stats1["evictions"]

    def release(self):
        self.eng = None

    def end_to_end(self) -> dict:
        from bench.main import say
        say(f"first tokens in the window: {len(self.ttft)}")
        return {"tok_s": self.tokens / self.run.window_s}

    # ------------------------------------------------------------ check
    def check(self) -> list:
        run = self.run
        e = run.config["engine"]
        page, pbw = e["page"], e["max_prompt"] // e["page"]
        dev = run.device
        cache = kref.empty(1, e["num_sets"], e["ways"], dev)
        want, evictions, refused_wrong = {}, 0, 0
        for txs, refused_hits in self.admit_txs:
            got_refused = 0
            for rid, refused in txs:
                keys = kref.prefix_block_keys(self.recs[rid].prompt, page)
                q = torch.zeros((1, pbw), dtype=torch.int32)
                q[0, :len(keys)] = torch.from_numpy(keys)
                en = torch.arange(pbw)[None] < len(keys)
                hit, _, _, ev = kref.access(cache, q.to(dev),
                                            torch.zeros_like(q).to(dev),
                                            en.to(dev), slot_value=True)
                n_hit = int(torch.cumprod(hit[0].int(), 0).sum())
                if refused:
                    got_refused += n_hit
                else:
                    want[rid] = n_hit
                evictions += int(ev.sum())
            refused_wrong += int(got_refused != refused_hits)
        hits_wrong = sum(int(rec.req.prefix_hits != want.get(rid))
                         for rid, rec in self.recs.items()
                         if rec.req.generated)
        return limits.checks(run.workload["name"], {
            "transactions_unknown": self.unknown,
            "prefix_hits_wrong": hits_wrong + refused_wrong,
            "evictions_wrong": abs(self.evictions - evictions),
            "logit_gap": self.served_gap()})

    def sample(self) -> list:
        """The finished requests the check reads: the longest and a draw
        from the seed."""
        n = self.run.traffic["check_requests"]
        done = sorted(self.done, key=lambda r: (
            -(len(r.prompt) + len(r.req.generated)), r.rid))
        if len(done) <= n:
            return done
        rng = np.random.default_rng((self.run.seed ^ 0x5EED) & gen.M64)
        rest = rng.choice(len(done) - 1, n - 1, replace=False) + 1
        return [done[0]] + [done[i] for i in sorted(rest)]

    def served_gap(self, fp8: bool = False) -> float:
        """The widest gap by which a served token's float32 logit lies
        below the best one at its position, over the sample (with
        ``fp8``: of the token that the fp8 control puts first).  A window
        that finished no request has nothing to judge: ``NOTHING``, above
        any limit."""
        seqs, pos, served = [], [], []
        for r in self.sample():
            gen_t = list(r.req.generated)
            n = len(r.prompt)
            seqs.append(list(r.prompt) + gen_t[:-1])
            pos.append(range(n - 1, n - 1 + len(gen_t)))
            served.append(torch.as_tensor(gen_t))
        if not seqs:
            return NOTHING
        ref = dense_lm.logits_at(self.weights, self.shape, seqs, pos)
        if fp8:
            ctl = dense_lm.logits_at(self.weights, self.shape, seqs, pos,
                                     fp8=True)
            served = [c.argmax(-1).cpu() for c in ctl]
        gap = 0.0
        for lg, tok in zip(ref, served):
            best = lg.max(-1).values
            got = lg.gather(-1, tok.to(lg.device)[:, None])[:, 0]
            gap = max(gap, float((best - got).max()))
        return gap
