"""Serving CLI of the port: batched requests through the k-way paged
engine, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --smoke --requests 16 --policy lru [--tinylfu] [--jitted] \\
        [--decode-block 4] [--backend torch|cuda|ref] [--device cpu]

Prints throughput, the prefix-cache hit ratio and the engine's stats.
Counterpart of ``repro/launch/serve.py`` with the same flags and traffic
(a shared prefix plus a random tail per request, random weights from
``--seed``).  ``--jitted`` runs the device-resident serving tick instead
of the host loop: on the card two CUDA graphs (admit, decode) replayed
with one host sync per tick, on the CPU the same body run eagerly;
``--decode-block`` sets the decode burst both modes schedule.  The MoE
archs (mixtral, dbrx) are served by the paged engine like the dense ones;
the SSM and encoder-decoder archs (and hymba, whose SSD heads the
reference's CLI excludes too) print the reference's message and exit 0.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.policies import Policy
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--policy", default="lru",
                    choices=[p.name.lower() for p in Policy])
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "cuda", "ref"],
                    help="prefix-cache backend: torch tensor ops, the CUDA "
                         "probe kernels, or the Python oracle")
    ap.add_argument("--tinylfu", action="store_true")
    ap.add_argument("--jitted", action="store_true",
                    help="device-resident serving tick: CUDA graphs on the "
                         "card, one host sync per tick (needs a traceable "
                         "backend: torch or cuda)")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode steps per engine tick (both modes run the "
                         "same burst schedule)")
    ap.add_argument("--shared-prefix", type=int, default=48,
                    help="tokens shared by all prompts (prefix-cache fodder)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    cfg = spec.smoke
    if not (cfg.has_attention and cfg.enc_layers == 0 and not cfg.has_ssm):
        print(f"{args.arch}: paged engine targets decoder-only attention "
              "archs (DESIGN.md §4); serving via plain batched decode only.")
        return 0
    ecfg = EngineConfig(
        page=8, num_sets=32, ways=8, policy=Policy[args.policy.upper()],
        tinylfu=args.tinylfu, max_batch=8, max_seq=256, private_pages=256,
        backend=args.backend, jitted=args.jitted,
        decode_block=args.decode_block)
    model = lm.init_params(cfg, seed=args.seed, device=args.device)
    eng = Engine(cfg, model, ecfg, device=args.device)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(2, cfg.vocab_size - 1, args.shared_prefix)
    t0 = time.time()
    for _ in range(args.requests):
        tail = rng.integers(2, cfg.vocab_size - 1, rng.integers(4, 16))
        eng.submit(np.concatenate([shared, tail]), max_new=args.max_new)
    fin = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in fin.values())
    print(f"served {len(fin)} requests, {total_new} tokens "
          f"in {dt:.1f}s ({total_new/dt:.1f} tok/s) on {eng.device}")
    print(f"prefix-cache hit ratio: {eng.hit_ratio():.3f}  stats: {eng.stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
