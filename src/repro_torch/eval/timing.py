"""Timing helpers shared by the throughput figures and the showdown harness.

Counterpart of ``repro/eval/timing.py``, with the same names and protocol:
``warmup`` repetitions are run and *discarded* (kernel builds, the caching
allocator's ramp-up, cache warm-up), then ``iters`` steady-state
repetitions are timed, each blocking on its result before the next starts.
The discard counts are part of the measurement's provenance: each timer
reports ``reps_discarded`` and tallies into a module counter that
``artifacts.make_artifact`` snapshots into the artifact's ``env`` block.

Where the reference blocks with ``jax.block_until_ready``, ``block``
synchronizes the CUDA device of every tensor in a result (walking tuples,
lists, dicts and dataclasses).  A CUDA call returns once its kernels are
queued, so an unblocked sample would time the dispatch alone; host values
(Python numbers, CPU tensors) need no block.
"""
import dataclasses
import time

import torch

#: running tally of this process's timing protocol, snapshotted into every
#: artifact's env block
_PROVENANCE = {"reps_discarded": 0, "steady_reps": 0, "timers": 0}


def timing_provenance() -> dict:
    """Snapshot of the warmup-discard / steady-state tallies."""
    return dict(_PROVENANCE)


def reset_timing_provenance() -> None:
    for k in _PROVENANCE:
        _PROVENANCE[k] = 0


def _tally(warmup: int, iters: int) -> None:
    _PROVENANCE["reps_discarded"] += warmup
    _PROVENANCE["steady_reps"] += iters
    _PROVENANCE["timers"] += 1


def _cuda_devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), found)
    return found


def block(result):
    """Wait until every CUDA tensor in ``result`` is computed; returns
    ``result``.  A no-op for host values."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def _samples(call, iters: int, warmup: int) -> list:
    """Per-repetition wall times of ``call()`` in seconds, each blocking on
    its result, after ``warmup`` discarded repetitions."""
    for _ in range(warmup):
        block(call())
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block(call())
        samples.append(time.perf_counter() - t0)
    _tally(warmup, iters)
    return samples


def _percentile(sorted_samples, p):
    """Nearest-rank percentile of an already-sorted sample list."""
    n = len(sorted_samples)
    idx = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
    return sorted_samples[idx]


def _stats(samples, warmup: int) -> dict:
    samples = sorted(samples)
    return {"p50": _percentile(samples, 50),
            "p90": _percentile(samples, 90),
            "iters": len(samples),
            "reps_discarded": warmup}


def time_jitted(fn, *args, iters=20, warmup=5):
    """Median (p50) wall time per call of ``fn(*args)`` (seconds)."""
    samples = sorted(_samples(lambda: fn(*args), iters, warmup))
    return _percentile(samples, 50)


def time_jitted_percentiles(fn, *args, iters=30, warmup=5):
    """Steady-state timing distribution of ``fn(*args)``:
    {"p50": s, "p90": s, "iters": n, "reps_discarded": warmup}."""
    return _stats(_samples(lambda: fn(*args), iters, warmup), warmup)


def time_chained_percentiles(step, iters=30, warmup=5):
    """Like ``time_jitted_percentiles`` for a state-chaining ``step()``
    that advances its own state and returns something to block on."""
    return _stats(_samples(step, iters, warmup), warmup)


def time_replay_percentiles(replay, iters=5, warmup=1):
    """p50/p90 wall time of a whole-trace replay callable (seconds).

    The timer blocks on ``replay()``'s return value itself, so a callable
    that returns unfinished CUDA tensors is timed to the end of its work,
    not its dispatch; for one that already syncs (returning a Python
    number) the block is a no-op."""
    return _stats(_samples(replay, iters, warmup), warmup)


def time_host(fn, *args, iters=3):
    """Mean wall time per call of a host-side callable."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    dt = (time.perf_counter() - t0) / iters
    _tally(0, iters)
    return dt
