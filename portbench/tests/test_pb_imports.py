"""No module a run loads has ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` as its whole top-level name (``repro_torch`` is the
port, and allowed)."""
import json
import os
import subprocess
import sys

from bench import main

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{pb!r}, {src!r}, {tests!r}]
import torch
import small
from bench import main, registry
bench = registry.benchmark()
for name in [w["name"] for w in bench["workloads"]]:
    for trace in (False, True):
        t0 = time.perf_counter()
        main.execute(bench, name, 3, 0.3, trace, torch.device("cpu"),
                     lambda: time.perf_counter() - t0,
                     config=small.config(name), traffic=small.traffic(name))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_run_loads_no_jax():
    src = SCRIPT.format(pb=PB, src=os.path.join(os.path.dirname(PB), "src"),
                        tests=os.path.join(PB, "tests"))
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(main.FORBIDDEN), tops & set(main.FORBIDDEN)


def test_forbidden_modules_by_whole_name():
    assert main.forbidden_modules(["repro_torch.core.kway", "numpy",
                                   "jaxlib_like", "reprox"]) == []
    assert main.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                   "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_module_loaded_after_the_window_refused(monkeypatch):
    """A module that a metric reader (or the check) loads after the window
    is caught before the result is printed."""
    import time
    import types

    import pytest
    import torch

    import small
    from bench import registry
    bench = registry.benchmark()
    orig = registry.metric_reader

    def loading(name):
        read = orig(name)

        def read_and_load(run):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return read(run)
        return read_and_load
    monkeypatch.setattr(registry, "metric_reader", loading)
    t0 = time.perf_counter()
    with pytest.raises(main.ForbiddenModule, match="jax"):
        main.execute(bench, "replay-ycsbc", 3, 0.3, True,
                     torch.device("cpu"), lambda: time.perf_counter() - t0,
                     config=small.config("replay-ycsbc"),
                     traffic=small.traffic("replay-ycsbc"))
