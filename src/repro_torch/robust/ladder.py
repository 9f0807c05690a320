"""Graceful-degradation backend ladder for trace replay.

Counterpart of ``repro/robust/ladder.py``.  The replay is attempted on the
fastest rung and descends on failure, every descent recorded as a
``robust.events`` event naming the rung abandoned, the rung taken and why.

Rungs, fastest first:

  1. ``cuda-resident-l1l2``: kernel 4, the L1-over-L2 hierarchy in one
     launch.  Opt-in: attempted only with a ``hierarchy`` of ``l1_sets >
     0``; skipped (``backend_unsupported``) with TinyLFU.  Both tiers live
     in device memory, so it has no size rule (the reference's
     ``vmem_budget`` skip of this rung has no counterpart).
  2. ``cuda-resident``: kernel 3, the whole trace in one launch.  Skipped
     (``smem_budget``) where ``kernels/replay.py`` ``resident_fits`` does
     not hold for the chunk width (the reference's ``vmem_budget`` rule).
  3. ``cuda-scan``: the chunked loop over the ``cuda`` backend's access
     (kernel 2; with TinyLFU kernel 1 peeks).
  4. ``torch-scan``: the chunked loop over the torch twin, the floor.  On
     the card it is taken only where the ``cuda`` backend refuses the
     configuration up front (below); on the CPU, where the ``cuda`` rungs
     run the kernels' plain versions, it is always available, as the
     reference's ``jnp-scan`` is.

The flat rungs are bit-identical, so a descent among them costs
throughput, never correctness; the L1L2 rung runs the hierarchy's
semantics and descends to the flat ones.  After each rung the final state
is validated (``robust.invariants``; both tiers and exclusivity for the
L1L2 rung): a dirty state descends with ``stale_served`` when the
violation is an expiry bit, ``validator_alarm`` otherwise, and the next
rung re-runs from the same initial state; an alarm on the last rung
open to the replay raises.  A configuration the ``cuda`` backend refuses
(sampled policies, more than ``MAX_WAYS`` ways) skips the ``cuda`` rungs
with a ``backend_unsupported`` event.

On the CPU the ladder descends on Python exceptions (``kernel_failure``)
and validator alarms, as the reference does.  On the card a kernel's
exception is raised to the caller: a failed build or launch never turns
into the torch twin's result.  There the descents are the ones between
kernels (``smem_budget`` to ``cuda-scan``, a validator alarm from kernel
4 or 3 to ``cuda-scan``), and ``cuda-scan`` is the last rung.  A sticky
CUDA fault (an illegal address, a kernel trap) leaves the CUDA context
unusable for the rest of the process, so no lower rung could run after
one anyway.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kway
from repro_torch.core.backend import HIER_TINYLFU, resolve_device
from repro_torch.core.kway import KWayConfig
from repro_torch.robust import events
from repro_torch.robust.invariants import (check_cache, check_hier,
                                           explain_cache, explain_hier,
                                           sketch_bits)

__all__ = ["RUNGS", "ReplayOutcome", "resilient_replay"]

#: fallback order, fastest first (the L1L2 rung is opt-in via
#: ``hierarchy``; without it the ladder starts at ``cuda-resident``)
RUNGS = ("cuda-resident-l1l2", "cuda-resident", "cuda-scan", "torch-scan")

_COMPONENT = "ladder.replay"


@dataclasses.dataclass(frozen=True)
class ReplayOutcome:
    """Result of a supervised replay: the replay outputs plus which rung
    produced them and what was attempted along the way."""

    hits: torch.Tensor           # int32 [steps]
    evs: torch.Tensor            # int32 [steps]
    state: object                # KWayState (flat rungs) | HierState (l1l2)
    sketch: object               # TinyLFUState | None
    rung: str                    # the rung that produced the result
    attempts: tuple              # ((rung, "ok"|reason), ...) in order


def _default_validate(cfg: KWayConfig, tinylfu, vals_mode: str,
                      hierarchy=None):
    def validate(state, sketch) -> tuple[bool, str]:
        from repro_torch.core import hierarchy as hier_mod
        if hierarchy is not None and isinstance(state, hier_mod.HierState):
            rep = check_hier(cfg, hierarchy, state, vals_mode=vals_mode)
            if not rep.clean():
                return False, "; ".join(explain_hier(rep, limit=4))
            return True, ""
        rep = check_cache(cfg, state, vals_mode=vals_mode)
        if not rep.clean():
            return False, "; ".join(explain_cache(rep, limit=4))
        if tinylfu is not None and sketch is not None:
            if int(sketch_bits(tinylfu, sketch)) != 0:
                return False, "tinylfu sketch bounds violated"
        return True, ""
    return validate


def resilient_replay(cfg: KWayConfig, chunks, enabled, tinylfu=None,
                     state: kway.KWayState | None = None, *,
                     hierarchy=None, validate: bool = True,
                     validate_fn=None, vals_mode: str = "key", ttls=None,
                     device=None) -> ReplayOutcome:
    """Replay ``chunks`` / ``enabled`` (the ``router.pad_chunks`` layout,
    payload ``val == key``) down the degradation ladder, on ``device``
    (the state's, else the card).

    ``hierarchy`` (``l1_sets > 0``) opts into the ``cuda-resident-l1l2``
    top rung; its descent target is the flat ``cuda-resident`` rung.
    ``ttls`` (int32 [steps, B]) replays with per-request TTLs on every
    rung; excludes ``tinylfu``.  ``validate_fn(state, sketch) -> (ok,
    why)`` overrides the invariant check per rung; ``validate=False``
    skips it."""
    from repro_torch.core import backend as backend_mod
    from repro_torch.kernels import replay as krp

    if ttls is not None:
        if tinylfu is not None:
            raise ValueError(
                "per-request TTLs and TinyLFU admission are mutually "
                "exclusive (the sketch has no expiry-aware semantics)")
        ttls = torch.as_tensor(ttls, dtype=torch.int32)
    if hierarchy is not None and not hierarchy.enabled:
        hierarchy = None
    dev = state.device if state is not None else resolve_device(device)
    if state is None:
        state = kway.make_cache(cfg, device=dev, ttl=ttls is not None)
    check = None
    if validate:
        check = validate_fn or _default_validate(cfg, tinylfu, vals_mode,
                                                 hierarchy=hierarchy)

    attempts: list = []
    on_card = _on_card(dev)

    def _attempt(rung: str, run, last: bool = False) -> ReplayOutcome | None:
        try:
            hits, evs, st, sk = run()
        except Exception as exc:  # noqa: BLE001 - off the card, any fault descends
            if on_card:
                raise
            attempts.append((rung, "kernel_failure"))
            events.record(
                component=_COMPONENT, reason="kernel_failure",
                fallback_from=rung, fallback_to=_next(rung),
                detail=f"{type(exc).__name__}: {exc}")
            return None
        if check is not None:
            ok, why = check(st, sk)
            if not ok:
                # an expiry-bit violation means the rung may have served
                # expired entries: name the descent for what it is
                reason = ("stale_served"
                          if "expired_hit" in why or "expired_resident" in why
                          else "validator_alarm")
                attempts.append((rung, reason))
                events.record(
                    component=_COMPONENT, reason=reason,
                    fallback_from=rung,
                    fallback_to="none" if last else _next(rung), detail=why)
                if last:
                    raise RuntimeError(
                        f"replay state invalid on the last ladder rung "
                        f"{rung!r}: {why}")
                return None
        attempts.append((rung, "ok"))
        return ReplayOutcome(hits=hits, evs=evs, state=st, sketch=sk,
                             rung=rung, attempts=tuple(attempts))

    # ---- cuda rungs ------------------------------------------------------
    try:
        cuda = backend_mod.make_backend("cuda", cfg, dev)
    except ValueError as exc:
        cuda = None
        if hierarchy is not None:
            attempts.append(("cuda-resident-l1l2", "backend_unsupported"))
        attempts.append(("cuda-resident", "backend_unsupported"))
        attempts.append(("cuda-scan", "backend_unsupported"))
        events.record(
            component=_COMPONENT, reason="backend_unsupported",
            fallback_from="cuda-resident", fallback_to="torch-scan",
            detail=str(exc))

    if cuda is not None and hierarchy is not None:
        if tinylfu is not None:
            attempts.append(("cuda-resident-l1l2", "backend_unsupported"))
            events.record(
                component=_COMPONENT, reason="backend_unsupported",
                fallback_from="cuda-resident-l1l2",
                fallback_to="cuda-resident", detail=HIER_TINYLFU)
        else:
            from repro_torch.core import hierarchy as hier_mod
            from repro_torch.kernels import ops

            hst = hier_mod.as_hier_state(cfg, hierarchy, state,
                                         ttl=ttls is not None)
            out = _attempt(
                "cuda-resident-l1l2",
                lambda: ops.replay_hierarchical(cfg, hierarchy, hst, chunks,
                                                enabled, ttls=ttls))
            if out is not None:
                return out

    if cuda is not None:
        batch = chunks.shape[1]
        if krp.resident_fits(cfg, batch, tinylfu is not None, dev):
            from repro_torch.kernels import ops

            out = _attempt(
                "cuda-resident",
                lambda: ops.replay_resident(cfg, state, chunks, enabled,
                                            tinylfu=tinylfu, ttls=ttls))
            if out is not None:
                return out
        else:
            attempts.append(("cuda-resident", "smem_budget"))
            need = krp.resident_smem_bytes(cfg, batch, tinylfu is not None)
            events.record(
                component=_COMPONENT, reason="smem_budget",
                fallback_from="cuda-resident", fallback_to="cuda-scan",
                detail=(f"kernel 3 does not take chunks of {batch} lanes of "
                        f"num_sets={cfg.num_sets} x ways={cfg.ways} "
                        f"(needs {need} B "
                        f"of shared memory per block, limit "
                        f"{krp.smem_limit(dev)}; at most {krp.MAX_BATCH} "
                        f"lanes); falling back to cuda-scan"))

        out = _attempt(
            "cuda-scan",
            lambda: cuda.replay_scan(state, chunks, enabled, tinylfu=tinylfu,
                                     ttls=ttls), last=on_card)
        if out is not None:
            return out

    # ---- floor: the CPU, or a configuration the cuda backend refused -----
    torch_be = backend_mod.make_backend("torch", cfg, dev)
    out = _attempt(
        "torch-scan",
        lambda: torch_be.replay(state, chunks, enabled, tinylfu=tinylfu,
                                ttls=ttls), last=True)
    if out is not None:
        return out
    raise RuntimeError(f"all ladder rungs failed for replay: {attempts}")


def _on_card(dev: torch.device) -> bool:
    """Whether the replay runs on the card, where a kernel's exception is
    raised and the torch twin is no fallback for the kernels."""
    return dev.type == "cuda"


def _next(rung: str) -> str:
    i = RUNGS.index(rung)
    return RUNGS[i + 1] if i + 1 < len(RUNGS) else "none"
