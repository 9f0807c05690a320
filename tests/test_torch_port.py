"""Refusals and boundaries of the PyTorch/CUDA port.

  * entry points run on the card unless asked for the CPU: without a card
    (the test hides any) they raise, naming the ``device="cpu"`` option;
  * options whose modules are not ported yet raise ``ValueError`` naming
    the ROADMAP item, and the option pairs the reference refuses raise
    ``ValueError`` too; ``shards > 1``, ported now, runs and equals the
    reference;
  * neither ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX or any
    module of ``repro`` (checked in a subprocess and in the sources);
  * ``chip_smoke.py`` fails, and prints no result, without a card;
  * the serving engine keeps the reference's refusals (the jitted tick
    needs a traceable backend and an unsharded cache; attention-free and
    encoder-decoder models) and nothing more: temperature sampling (ROADMAP
    Queue A item 12b) and MoE and hybrid models, ported now, run.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import admission, simulate
from repro_torch.core.backend import make_backend
from repro_torch.core.hierarchy import HierarchyConfig
from repro_torch.core.kway import KWayConfig

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")
CFG = KWayConfig(num_sets=8, ways=4)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["torch", "cuda", "ref"])
def test_default_device_is_the_card(no_card, backend):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_backend(backend, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_backend(backend, CFG, device="cuda")
    assert make_backend(backend, CFG, device="cpu").init().keys.device.type \
        == "cpu"


def test_simconfig_default_device_is_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate.SimConfig(CFG)
    assert simulate.SimConfig(CFG, device="cpu").backend == "cuda"


TL = admission.for_capacity(32)
HIER = HierarchyConfig(l1_sets=2, l1_ways=2)


@pytest.mark.parametrize("sim_kw,kwargs,match", [
    pytest.param({}, dict(shards=2), None, id="kwargs0-Queue A item 8"),
    pytest.param(dict(two_phase=True), dict(hierarchy=HIER), "two_phase",
                 id="kwargs1-Queue B item 4"),
])
def test_unported_options_refused(sim_kw, kwargs, match):
    """No option of ``replay_batched`` is left to port: ``shards > 1``
    (ROADMAP Queue A item 8) runs and gives the reference's hit ratio
    (``match`` None), and the hierarchy refuses ``two_phase`` as the
    reference does."""
    sim = simulate.SimConfig(CFG, device="cpu", **sim_kw)
    if match is None:
        from repro.core import simulate as jsim
        from repro.core.kway import KWayConfig as JConfig
        tr = np.random.default_rng(0).integers(0, 40, 300).astype(np.uint32)
        want = jsim.replay_batched(jsim.SimConfig(JConfig(num_sets=8,
                                                          ways=4)),
                                   tr, batch=16, **kwargs)
        assert simulate.replay_batched(sim, tr, batch=16, **kwargs) == want
        assert want > 0
        return
    with pytest.raises(ValueError, match=match):
        simulate.replay_batched(sim, np.arange(10, dtype=np.uint32), **kwargs)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tinylfu_refused(backend):
    """TinyLFU is ported; it refuses TTLs and the hierarchy, as the
    reference does, on the entry point and on the backend."""
    sim = simulate.SimConfig(CFG, tinylfu=TL, backend=backend, device="cpu")
    tr = np.arange(10, dtype=np.uint32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        simulate.replay_batched(sim, tr, ttls=np.ones(10, np.int32))
    with pytest.raises(ValueError, match="TinyLFU"):
        simulate.replay_batched(sim, tr, hierarchy=HIER)
    be = make_backend(backend, CFG, device="cpu")
    chunks, en = tr.reshape(2, 5), np.ones((2, 5), bool)
    with pytest.raises(ValueError, match="mutually exclusive"):
        be.replay(be.init(), chunks, en, tinylfu=TL,
                  ttls=np.ones((2, 5), np.int32))
    with pytest.raises(ValueError, match="TinyLFU"):
        be.replay(be.init(), chunks, en, tinylfu=TL, hierarchy=HIER)
    assert 0 <= simulate.replay(sim, tr) <= 1


def test_ref_backend_refuses_tinylfu_and_hierarchy():
    sim = simulate.SimConfig(CFG, tinylfu=TL, backend="ref", device="cpu")
    tr = np.arange(10, dtype=np.uint32)
    for run in (simulate.replay, simulate.replay_batched):
        with pytest.raises(ValueError, match="ref backend"):
            run(sim, tr)
    sim = simulate.SimConfig(CFG, backend="ref", device="cpu")
    with pytest.raises(ValueError, match="flat-only"):
        simulate.replay_batched(sim, tr, hierarchy=HIER)
    be = make_backend("ref", CFG, device="cpu")
    chunks, en = tr.reshape(2, 5), np.ones((2, 5), bool)
    with pytest.raises(ValueError, match="ref backend"):
        be.replay(be.init(), chunks, en, tinylfu=TL)
    with pytest.raises(ValueError, match="flat-only"):
        be.replay(be.init(), chunks, en, hierarchy=HIER)


def test_replay_refusals():
    sim = simulate.SimConfig(CFG, backend="ref", device="cpu")
    tr = np.arange(10, dtype=np.uint32)
    with pytest.raises(ValueError, match="ref"):
        simulate.replay_batched(sim, tr, resident=True)
    sim = simulate.SimConfig(CFG, backend="torch", two_phase=True,
                             device="cpu")
    with pytest.raises(ValueError, match="two_phase"):
        simulate.replay_batched(sim, tr, ttls=np.ones(10, np.int32))
    with pytest.raises(ValueError, match="length"):
        simulate.replay_batched(simulate.SimConfig(CFG, device="cpu"), tr,
                                ttls=np.ones(9, np.int32))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_and_no_repro():
    """Import every port module (and chip_smoke) in a fresh interpreter and
    check sys.modules."""
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.dirname(PORT))
                mods.append(rel[:-3].replace(os.sep, ".")
                            .removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 14


def test_port_sources_import_no_jax_and_no_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


class _StubLib:
    """Stands in for a ctypes library: records what the wrappers declare."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("module,source", [
    ("kway_probe", "kway_probe.cu"), ("replay", "replay.cu"),
    ("replay", "replay_hier.cu"), ("paged_attention", "paged_attention.cu"),
    ("adamw", "adamw.cu")])
def test_ctypes_declarations_match_c_entries(monkeypatch, module, source):
    """Every C entry's parameter list (void* / int / long long / float)
    equals the argtypes its wrapper declares; a mismatch would only show
    on the card."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    loader = getattr(mod, {"replay_hier.cu": "_hier_lib"}.get(source, "_lib"))
    stub = _StubLib()
    monkeypatch.setattr(_build, "library", lambda name: stub)
    loader.cache_clear()
    try:
        loader()
    finally:
        loader.cache_clear()
    with open(os.path.join(PORT, "kernels", "csrc", source)) as f:
        src = f.read()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert entries and {n for n, _ in entries} == set(stub.fns)
    for name, params in entries:
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if "float" in p else
                 ctypes.c_longlong if "long long" in p else ctypes.c_int
                 for p in params.split(",")]
        assert stub.fns[name].argtypes == kinds, name
        assert stub.fns[name].restype is ctypes.c_int


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _serve_cfg(arch="deepseek-7b"):
    from repro_torch import configs
    return configs.get(arch).smoke


def _jserve_cfg(arch="deepseek-7b"):
    from repro import configs
    return configs.get(arch).smoke


@pytest.mark.parametrize("ecfg_kw,match", [
    (dict(jitted=True, backend="ref"), "traceable"),
    (dict(jitted=True, shards=2), "unsharded"),
    pytest.param(dict(temperature=0.7, sample_seed=5), None,
                 id="ecfg_kw2-Queue A item 12"),
    pytest.param(dict(shards=2), None, id="ecfg_kw3-Queue A item 8"),
    (dict(max_seq=100, page=16), "multiple of page"),
    (dict(decode_block=0), "decode_block"),
    (dict(max_prompt=24, page=16), "max_prompt"),
    (dict(max_prompt=1024, max_seq=512), "max_prompt"),
])
def test_engine_refusals(ecfg_kw, match):
    """The reference's own refusals raise ValueError before the model is
    touched.  ``shards > 1`` (ROADMAP Queue A item 8) and temperature
    sampling (item 12b), ``match`` None, are ported: the host loop runs
    them and equals the reference engine's run in stats, pages and prefix
    hits, and the sampled run in tokens too."""
    from repro_torch.serve.engine import Engine, EngineConfig
    if match is None:
        import jax
        from repro import configs as jconfigs
        from repro.models import lm as jlm
        from repro.serve import engine as jeng
        from repro_torch.models import lm
        cfg, jcfg = _serve_cfg(), _jserve_cfg()
        jparams = jlm.init_params(jcfg, jax.random.key(0))
        model = lm.params_from_numpy(
            cfg, jax.tree.map(np.asarray, jax.device_get(jparams)),
            device="cpu")
        kw = dict(ecfg_kw, page=8, num_sets=4, ways=2, max_batch=2,
                  max_seq=64)
        runs = []
        for eng in (Engine(cfg, model, EngineConfig(**kw), device="cpu"),
                    jeng.Engine(jcfg, jparams, jeng.EngineConfig(**kw))):
            r = np.random.default_rng(3)
            shared = r.integers(2, 400, 16)
            for n in (3, 9, 12):
                eng.submit(np.concatenate([shared, r.integers(2, 400, n)]),
                           max_new=2)
            fin = eng.run()
            runs.append((eng.stats, {i: (q.pages, q.prefix_hits) + (
                (list(q.generated),) if "temperature" in ecfg_kw else ())
                for i, q in fin.items()}))
        assert runs[0] == runs[1] and runs[0][0]["prefix_hits"] > 0
        return
    with pytest.raises(ValueError, match=match):
        Engine(_serve_cfg(), None, EngineConfig(**ecfg_kw), device="cpu")


@pytest.mark.parametrize("arch,match", [
    ("mamba2-130m", "decoder-only attention"),
    ("seamless-m4t-large-v2", "decoder-only attention"),
    pytest.param("mixtral-8x22b", None, id="mixtral-8x22b-MoE"),
    pytest.param("hymba-1.5b", None, id="hymba-1.5b-SSM")])
def test_engine_refuses_unported_layers(arch, match):
    """The engine refuses what the reference's refuses (no attention, an
    encoder) and serves MoE and hybrid models (``match`` None), which it
    refused before they were ported."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, EngineConfig
    if match is None:
        cfg = _serve_cfg(arch)
        eng = Engine(cfg, lm.init_params(cfg, device="cpu"),
                     EngineConfig(page=8, num_sets=4, ways=2, max_batch=2,
                                  max_seq=64), device="cpu")
        eng.submit(np.arange(2, 21, dtype=np.int32), max_new=3)
        (req,) = eng.run().values()
        assert len(req.generated) == 4
        return
    with pytest.raises(ValueError, match=match):
        Engine(_serve_cfg(arch), None, EngineConfig(), device="cpu")


def test_engine_and_cli_run_on_the_card_by_default(no_card):
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = _serve_cfg()
    model = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, EngineConfig(max_seq=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1", "--max-new", "1"])
    assert serve.main(["--jitted", "--requests", "2", "--max-new", "2",
                       "--device", "cpu"]) == 0
    eng = Engine(cfg, model, EngineConfig(max_seq=64), device="cpu")
    assert eng.pool_k.device.type == "cpu"
    assert serve.main(["--requests", "2", "--max-new", "2",
                       "--device", "cpu"]) == 0


@pytest.mark.parametrize("shape,want", [
    # deepseek-7b serving: page 16, D 128 bf16, PPS 64, 8 sequences x 32
    # KV heads on 132 SMs: 4 warps, 2 pages each, 8 splits
    (dict(page=16, d=128, itemsize=2, pps=64, b=8, kvh=32), (4, 8, 8)),
    # one sequence: smaller CTAs until the grid holds 4 CTAs per SM
    (dict(page=16, d=128, itemsize=2, pps=64, b=1, kvh=32), (4, 2, 32)),
    # float32 D 256 in 32-token pages: one warp's ring is 128 KiB
    (dict(page=32, d=256, itemsize=4, pps=8, b=2, kvh=2), (1, 1, 8)),
    (dict(page=8, d=64, itemsize=2, pps=3, b=200, kvh=4), (4, 8, 1)),
])
def test_paged_attention_split_plan(shape, want):
    """Kernel 5's split comes from the shapes and the SM count alone (never
    from seq_lens): every page of the table falls in one split, and a
    warp's page ids fit its lanes."""
    from repro_torch.kernels import paged_attention as kpa
    w, ppc, s = kpa.split_plan(**shape, sms=132)
    assert (w, ppc, s) == want
    assert s * ppc >= shape["pps"] > (s - 1) * ppc
    assert 1 <= w <= 4 and ppc <= 32 * w


@pytest.mark.parametrize("l1,l2_ways,expiry,form", [
    ((512, 16), 8, True, "shared"),      # the chip configuration, 192 KiB
    ((1024, 16), 8, False, "global"),    # 320 KiB
    ((512, 22), 8, False, "shared"),     # the widest 512-set L1 that fits
    ((512, 23), 8, False, "global"),
    ((64, 48), 40, True, "shared"),      # two ways per thread
])
def test_replay_hier_l1_form_by_size(monkeypatch, l1, l2_ways, expiry, form):
    """Kernel 4 keeps the L1 in shared memory exactly when the L1 lanes and
    its ring of prefetched L2 rows fit the opt-in shared memory per block
    (232,448 B on an H100); the ring holds 8 rows of 6 lanes x 32 ways per
    way-slot of a thread."""
    from repro_torch.core import hierarchy
    from repro_torch.core.kway import KWayConfig
    from repro_torch.kernels import replay as krp
    monkeypatch.setattr(krp, "_smem_optin", lambda device: 232448)
    cfg = KWayConfig(num_sets=64, ways=l2_ways)
    hc = hierarchy.HierarchyConfig(l1_sets=l1[0], l1_ways=l1[1])
    ring, l1_bytes = krp.hier_smem_bytes(cfg, hc, expiry)
    assert ring == 4 * krp.HIER_RING * 6 * 32 * (1 if max(l1[1], l2_ways)
                                                  <= 32 else 2)
    assert l1_bytes == 4 * (5 + expiry) * l1[0] * l1[1]
    assert krp.hier_l1_form(cfg, hc, expiry, "cpu") == form


@pytest.mark.parametrize("sets,ways,batch,tinylfu,need,fits", [
    # chip_smoke.py's configuration: 4 warps x (16 + 3 x 128) ints
    (131072, 8, 1024, False, 6400, True),
    # 2^26-entry caches at B = 8192: the owners form's scratch overflows
    (2**23, 8, 8192, False, 409600, False),
    (2**22, 16, 8192, False, 401408, False),
    (2**20, 64, 8192, False, 395264, False),
    (32, 8, 16384, False, 6400, True),       # MAX_BATCH lanes
    (32, 8, 16385, False, 6400, False),      # one lane over MAX_BATCH
    # TinyLFU's grid form: one warp's scratch (2^14 sets an owner, a bit
    # per lane) on each side of the opt-in
    (2**27, 1, 13760, True, 232376, True),
    (2**27, 1, 13792, True, 232764, False),
    (32, 8, 15, True, 210, True),            # block form: 14 B a lane
])
def test_replay_resident_fits_by_size(monkeypatch, sets, ways, batch, tinylfu,
                                      need, fits):
    """Kernel 3 takes a shape exactly when its chunks hold at most
    MAX_BATCH lanes and its form's shared memory fits the opt-in per block
    (232,448 B on an H100), with the C code's formula: 4 warps x 4 B x
    (sets an owner + 3 x min(B, ways x sets an owner)) for the owners form,
    one warp's share plus a bit per lane for the grid form."""
    from repro_torch.kernels import replay as krp
    monkeypatch.setattr(krp, "_smem_optin", lambda device: 232448)
    cfg = KWayConfig(num_sets=sets, ways=ways)
    assert krp.resident_smem_bytes(cfg, batch, tinylfu) == need
    assert krp.resident_fits(cfg, batch, tinylfu, "cpu") is fits


def test_size_rules_read_no_shared_memory_off_the_card():
    """Off the card the wrappers run the plain versions, which use no
    shared memory: the rules on size read no opt-in there, and only kernel
    3's batch limit stands."""
    from repro_torch.kernels import replay as krp
    assert krp._smem_optin(torch.device("cpu")) is None
    cfg = KWayConfig(num_sets=2**23, ways=8)
    assert krp.resident_smem_bytes(cfg, 8192, False) == 409600
    assert krp.resident_fits(cfg, 8192, False, "cpu")
    assert not krp.resident_fits(cfg, krp.MAX_BATCH + 1, False, "cpu")


@pytest.mark.parametrize("case", ["batch", "smem", "tinylfu-smem"])
def test_cuda_replay_takes_the_chunked_path_where_kernel3_does_not_fit(
        monkeypatch, case):
    """Where the rule says no, ``CudaBackend.replay`` records one
    ``smem_budget`` event and returns the chunked path's results (equal to
    the torch twin's); kernel 3's entry is never reached."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import replay as krp
    from repro_torch.robust import events
    optin = 232448 if case == "batch" else 400
    monkeypatch.setattr(krp, "_smem_optin", lambda device: optin)

    def refused(*args, **kw):
        raise AssertionError("kernel 3 was called")

    monkeypatch.setattr(ops, "replay_resident", refused)
    monkeypatch.setattr(krp, "replay_resident", refused)
    cfg = KWayConfig(num_sets=16, ways=2)
    batch = krp.MAX_BATCH + 1 if case == "batch" else 64
    tl = admission.for_capacity(cfg.capacity) if case == "tinylfu-smem" \
        else None
    assert not krp.resident_fits(cfg, batch, tl is not None, "cpu")
    rng = np.random.default_rng(4)
    tr = rng.integers(0, 200, 2 * batch).astype(np.uint32)
    chunks, en = tr.reshape(2, batch), np.ones((2, batch), bool)
    en[1, -5:] = False
    cb = make_backend("cuda", cfg, device="cpu")
    tb = make_backend("torch", cfg, device="cpu")
    cur = events.cursor()
    got = cb.replay(cb.init(), chunks, en, tinylfu=tl)
    new = events.since(cur)
    assert len(new) == 1 and (new[0].component, new[0].reason,
                              new[0].fallback_to) == (
        "cuda.replay", "smem_budget", "cuda-scan")
    want = tb.replay(tb.init(), chunks, en, tinylfu=tl)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for f in ("keys", "fprint", "vals", "meta_a", "meta_b", "clock"):
        assert torch.equal(getattr(got[2], f), getattr(want[2], f)), f
    if tl is not None:
        assert torch.equal(got[3].packed, want[3].packed)
