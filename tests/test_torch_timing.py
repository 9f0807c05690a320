"""The port's timing protocol (``repro_torch/eval/timing.py``) against the
reference's (``repro/eval/timing.py``): the same nearest-rank percentile,
the same warmup-discard tallies, and a block that is a no-op for host
values.  Blocking on a CUDA result is held on the card
(``tests/test_torch_gpu.py``)."""
import dataclasses
import time

import pytest
import torch

from repro.eval import timing as ref_timing
from repro_torch.eval import timing


@pytest.mark.parametrize("n", [1, 2, 3, 5, 10, 30])
@pytest.mark.parametrize("p", [0, 10, 50, 90, 99, 100])
def test_percentile_equals_reference(n, p):
    samples = sorted((i * 7919) % 101 / 10.0 for i in range(n))
    assert timing._percentile(samples, p) == ref_timing._percentile(samples, p)


@pytest.mark.parametrize("warmup,iters", [(0, 1), (1, 3), (3, 2), (5, 30)])
def test_tallies_equal_reference(warmup, iters):
    timing.reset_timing_provenance()
    ref_timing.reset_timing_provenance()
    for mod in (timing, ref_timing):
        mod.time_replay_percentiles(lambda: 0, iters=iters, warmup=warmup)
        mod.time_chained_percentiles(lambda: 1, iters=iters, warmup=warmup)
        mod.time_jitted_percentiles(lambda x: x, 3, iters=iters,
                                    warmup=warmup)
        mod.time_jitted(lambda x: x, 3, iters=iters, warmup=warmup)
        mod.time_host(lambda: None, iters=iters)
    assert timing.timing_provenance() == ref_timing.timing_provenance()
    assert timing.timing_provenance() == {
        "reps_discarded": 4 * warmup, "steady_reps": 5 * iters, "timers": 5}


def test_stats_shape():
    st = timing.time_replay_percentiles(lambda: 42, iters=3, warmup=2)
    assert set(st) == {"p50", "p90", "iters", "reps_discarded"}
    assert st["iters"] == 3 and st["reps_discarded"] == 2
    assert 0.0 <= st["p50"] <= st["p90"]


@dataclasses.dataclass
class _Box:
    a: torch.Tensor
    b: list


def test_block_is_noop_for_host_values():
    values = [42, 1.5, None, "x", torch.ones(3), (torch.zeros(2), [7]),
              {"k": torch.ones(1)}, _Box(torch.ones(2), [torch.ones(1)])]
    for v in values:
        assert timing.block(v) is v
    assert timing._cuda_devices(values, set()) == set()


def test_samples_cover_the_call():
    """Each sample covers the whole call (here a host sleep)."""
    delay = 0.01

    def replay():
        time.sleep(delay)
        return 0

    st = timing.time_replay_percentiles(replay, iters=3, warmup=1)
    assert st["p50"] >= 0.8 * delay
