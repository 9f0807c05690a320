"""Schema-versioned benchmark artifacts + baseline regression gating.

Counterpart of ``repro/eval/artifacts.py`` with the same schema, so a
baseline committed by the reference and an artifact of the port diff
against each other:

    {
      "schema_version": 1,
      "kind": "repro_torch.eval.artifact",
      "figure": "hit_ratio_vs_associativity",
      "env":    {python/torch/CUDA/numpy versions, platform, device, card},
      "spec":   {the declarative sweep grid, incl. seeds and trace families},
      "skipped": ["...unsupported combos, never silently dropped..."],
      "records": [{"id": "zipf/LRU/k8/torch/none", "metric": "hit_ratio",
                   "value": 0.83, "per_seed": [...], "comparable": true,
                   ...config fields...}, ...]
    }

``records[*].id`` is the join key.  Records with ``comparable: true``
(deterministic metrics: hit ratios, violation counts) are tolerance-gated
against the baseline; timing records carry ``comparable: false`` and are
kept for trend inspection only.

The reference's ids name its backends (``jnp``, ``pallas``, ``vmem``);
the port's name the port's (``torch``, ``cuda``, ``smem``).  ``port_id``
maps the one onto the other, and ``compare_to_baseline`` applies it to a
baseline of the reference's kind.
"""
from __future__ import annotations

import json
import os
import platform
import re
import subprocess
import sys
import time

SCHEMA_VERSION = 1
KIND = "repro_torch.eval.artifact"
#: the reference's kind: its committed baselines load as they are
REF_KIND = "repro.eval.artifact"
DEFAULT_TOL = 0.01  # hit ratios are deterministic; tol absorbs lib drift

#: whole id tokens of the reference's backends -> the port's
_PORT_TOKENS = {"jnp": "torch", "pallas": "cuda", "vmem": "smem"}


def port_id(ref_id: str) -> str:
    """A reference record id in the port's words: whole tokens (split on
    ``/`` and ``-``, and, for the reasons of a ``skipped`` entry, on ``:``
    and spaces) ``jnp`` -> ``torch``, ``pallas`` -> ``cuda``, ``vmem`` ->
    ``smem``; every other token as it is."""
    parts = re.split(r"([/\-:\s])", ref_id)
    return "".join(_PORT_TOKENS.get(p, p) for p in parts)


def _card_power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def environment(device=None) -> dict:
    """Provenance of a run: versions, platform, the device the figures ran
    on and, on the card, ``nvidia-smi``'s name and power limit."""
    import numpy as np
    import torch

    from repro_torch.eval import timing
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda" and torch.cuda.is_available()
    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "platform": platform.platform(),
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else platform.processor() or "cpu"),
        "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                         else 1),
        "card_power_limit": _card_power_limit() if on_card else None,
        # warmup-discard / steady-state tallies of every timer that ran in
        # this process before the artifact was written (eval/timing.py)
        "timing": timing.timing_provenance(),
    }


def make_artifact(figure: str, spec: dict, records: list,
                  skipped: list | None = None, device=None) -> dict:
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": KIND,
        "figure": figure,
        "created_unix": int(time.time()),
        "env": environment(device),
        "spec": spec,
        "skipped": skipped or [],
        "records": records,
    }


def write_artifact(path: str, artifact: dict) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_artifact(path: str) -> dict:
    """An artifact of the port's kind or of the reference's."""
    with open(path) as f:
        art = json.load(f)
    if art.get("kind") not in (KIND, REF_KIND):
        raise ValueError(f"{path}: not a {KIND} or {REF_KIND} file")
    if art.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema_version {art.get('schema_version')} != "
            f"{SCHEMA_VERSION} — regenerate the baseline "
            "(python -m repro_torch.eval ... --out <baseline>)")
    return art


def compare_to_baseline(fresh: dict, baseline: dict,
                        tol: float = DEFAULT_TOL) -> list[str]:
    """Diff a fresh artifact against a baseline.  Returns breach strings
    (empty == pass).  Rules, as the reference's:

      * every ``comparable`` baseline record must exist in the fresh run
        (missing coverage is a breach, not a skip);
      * |fresh - baseline| must be <= the record's ``tol`` (or ``tol`` arg);
      * non-comparable (timing) records are ignored.

    A baseline of the reference's kind is joined through ``port_id``."""
    if fresh.get("figure") != baseline.get("figure"):
        return [f"figure mismatch: fresh={fresh.get('figure')!r} "
                f"baseline={baseline.get('figure')!r}"]
    fresh_by_id = {r["id"]: r for r in fresh["records"]}
    join = port_id if baseline.get("kind") == REF_KIND else (lambda i: i)
    breaches = []
    for base in baseline["records"]:
        if not base.get("comparable", False):
            continue
        rid = join(base["id"])
        new = fresh_by_id.get(rid)
        if new is None:
            breaches.append(f"{rid}: present in baseline, missing from run")
            continue
        limit = base.get("tol", tol)
        delta = new["value"] - base["value"]
        if abs(delta) > limit:
            breaches.append(
                f"{rid}: {base['metric']} {new['value']:.4f} vs baseline "
                f"{base['value']:.4f} (delta {delta:+.4f} > tol {limit})")
    return breaches
