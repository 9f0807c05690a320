#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload replay-ycsbc --seed 7 --seconds 30 \
        --trace 0

Run from the root of a checkout on a machine with the card.  It imports
the PyTorch/CUDA package from ``src/`` and nothing of the JAX package.
"""
import os
import sys
import time

_T0 = time.perf_counter()


def _age() -> float:
    """Seconds since this process started, by /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _age()


def setup_clock() -> float:
    return _AGE + time.perf_counter() - _T0


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(REPO, "src")]
# kernel caches of any library the run loads stay inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)

if __name__ == "__main__":
    from bench.main import main
    sys.exit(main(sys.argv[1:], setup_clock))
