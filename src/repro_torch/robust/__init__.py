"""Robustness layer of the port.  Ported so far: the degradation-event log
(:mod:`repro_torch.robust.events`) and the watchdog over the serving tick's
one host sync (:mod:`repro_torch.robust.watchdog`); validators, faults,
recovery and the ladder are still to port (ROADMAP Queue A item 10)."""
from repro_torch.robust import events  # noqa: F401
