"""Fault tolerance for the port's k-way serving stack.

Counterpart of ``repro/robust``.  The cache is a handful of dense
``[sets, ways]`` lanes with explicit metadata, so structural corruption is
cheap to detect (one vectorized pass) and cheap to repair (reset the
damaged sets and keep serving):

  * :mod:`repro_torch.robust.invariants`: structural validators over
    ``KWayState`` (the TTL bits included, both tiers and exclusivity for a
    ``HierState``), the TinyLFU sketch and the tick's ``ServeState``,
    returning violation bitmaps, and ``explain_*`` naming set / way / slot
    / page;
  * :mod:`repro_torch.robust.faults`: the deterministic fault injector,
    every fault reproducible from ``(seed, site, step)``;
  * :mod:`repro_torch.robust.recovery`: scrub-and-invalidate repair,
    ``validated_replay``, and engine checkpoint / restore through
    ``ckpt/manager.py``'s atomic-rename protocol;
  * :mod:`repro_torch.robust.ladder`: the degradation ladder (kernel 4 ->
    kernel 3 -> the chunked ``cuda`` path -> the torch twin), every
    descent a :mod:`repro_torch.robust.events` event;
  * :mod:`repro_torch.robust.watchdog`: bounded retry / backoff around the
    serving tick's one host sync.
"""
from repro_torch.robust import events, faults  # noqa: F401
from repro_torch.robust.faults import FaultReport  # noqa: F401
from repro_torch.robust.invariants import (  # noqa: F401
    CacheReport,
    HierReport,
    ServeReport,
    check_cache,
    check_hier,
    check_serve,
    explain_cache,
    explain_hier,
    explain_serve,
)
from repro_torch.robust.ladder import ReplayOutcome, resilient_replay  # noqa: F401
from repro_torch.robust.recovery import (  # noqa: F401
    CheckpointedEngine,
    restore_engine,
    save_engine,
    scrub,
    scrub_hier,
    validated_replay,
)
from repro_torch.robust.watchdog import WatchdogTimeout, watch  # noqa: F401
