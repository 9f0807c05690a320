"""repro_torch.eval — the paper-figure sweep, on the port.

Counterpart of ``repro/eval``:

  * ``runner``    — declarative sweep grids (trace family x policy x ways x
    backend x admission), ``torch`` points replayed as config-stacked
    groups (one CUDA graph per cache shape on the card), ``cuda`` points as
    one kernel-3 launch each;
  * ``figures``   — the twelve figure entry points (``FIGURES``);
  * ``artifacts`` — the reference's ``BENCH_*.json`` schema with the
    port's provenance, and baseline comparison with tolerance gating
    (``port_id`` joins the reference's committed baselines);
  * ``timing``    — warmup-discard percentile timers that block on CUDA
    results;
  * ``python -m repro_torch.eval --fig <name> [--quick] [--baseline f]
    [--device cuda|cpu]`` — the CLI over all of the above.
"""
from repro_torch.eval import artifacts, figures, runner  # noqa: F401
