"""Robustness layer of the port.  Only the degradation-event log
(:mod:`repro_torch.robust.events`) is ported so far; validators, faults,
recovery, the ladder and the watchdog are still to port (ROADMAP Queue A
item 10)."""
from repro_torch.robust import events  # noqa: F401
