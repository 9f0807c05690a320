"""The controls (``portbench/control.py``) come out as not correct: the
cache reference with its LRU guarantee broken, and the fp8 forward in the
bf16 program's place.  At small sizes on the CPU here; at the cells' own
sizes on the card (``-m gpu``, three seeds each)."""
import pytest
import torch

import control
import small
from bench import limits, main, registry

BENCH = registry.benchmark()
CACHE = ["replay-ycsbc"]
SERVE = ["serve-sessions"]


def make_run(name, seed, device, sized=True, seconds=None):
    wl = registry.find(BENCH["workloads"], name, "workload")
    cfg = registry.config(BENCH, wl) if sized else small.config(name)
    tr = registry.traffic(wl["traffic"]) if sized else small.traffic(name)
    return main.Run(workload=wl, config=cfg, traffic=tr, seed=seed,
                    seconds=seconds or small.seconds(name), trace=False,
                    device=device,
                    kind=main.device_kind(device))


def fails(name, numbers: dict) -> bool:
    return not all(c.ok for c in limits.checks(name, numbers))


@pytest.mark.parametrize("name", CACHE)
def test_cache_control_small(name):
    run = make_run(name, 5, torch.device("cpu"), sized=False)
    out = control.cache_control(run)
    assert fails(name, out), out


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_small(name, monkeypatch):
    small.steady_clock(monkeypatch, name)
    run = make_run(name, 5, torch.device("cpu"), sized=False)
    out = control.serve_control(run)
    assert out["control_logit_gap"] > 3 * out["program"]["logit_gap"]
    assert out["control_logit_gap"] > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("name", CACHE)
def test_cache_control_on_card(name, seed):
    out = control.cache_control(make_run(name, seed, _card()))
    assert fails(name, out), out


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("name", SERVE)
def test_serve_control_on_card(name, seed):
    out = control.serve_control(make_run(name, seed, _card(), seconds=10))
    numbers = dict(out["program"], logit_gap=out["control_logit_gap"])
    assert fails(name, numbers), out
