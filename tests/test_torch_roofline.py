"""The port's roofline: the reference's six cases (HLO parsing,
extrapolation, term math, report) on H100 constants, and the port's own
counters (FLOPs, bytes, collectives, live bytes) on hand-counted work."""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.roofline import analysis as ref_roof
from repro_torch import configs
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis as roof


def test_h100_constants():
    assert roof.PEAK_FLOPS == 989e12
    assert roof.HBM_BW == 3.35e12
    assert roof.LINK_BW == 450e9


def test_shape_bytes():
    assert roof._shape_bytes("f32[128,256]") == 128 * 256 * 4
    assert roof._shape_bytes("bf16[2,3,4]") == 24 * 2
    assert roof._shape_bytes("pred[10]") == 10
    assert roof._shape_bytes("(f32[4], s32[8])") == 16 + 32
    assert roof._shape_bytes("f32[]") == 4  # scalar


def test_collective_scrape():
    hlo = """
  %ar = f32[16,4096]{1,0} all-reduce(%x), replica_groups=...
  %ag.1 = bf16[8,128]{1,0} all-gather(%y), dimensions={0}
  %notacoll = f32[2,2]{1,0} add(%a, %b)
  %tup = (f32[4]{0}, f32[4]{0}) all-reduce(%p, %q), to_apply=%add
  %cp = u32[64]{0} collective-permute(%z), source_target_pairs=...
"""
    out = roof.collective_bytes_per_device(hlo)
    assert out["all-reduce"] == 16 * 4096 * 4 + 2 * 16
    assert out["all-gather"] == 8 * 128 * 2
    assert out["collective-permute"] == 64 * 4
    assert "add" not in out


def test_extrapolation_linear():
    fixed, layer, L = 100.0, 7.0, 24
    total = roof.extrapolate(fixed + layer, fixed + 2 * layer, L)
    assert math.isclose(total, fixed + L * layer)
    d = roof.extrapolate_dict({"a": fixed + layer}, {"a": fixed + 2 * layer,
                                                     "b": 1.0}, L)
    assert math.isclose(d["a"], fixed + L * layer)
    assert math.isclose(d["b"], (L - 1) * 1.0)


def test_cell_terms_and_bottleneck():
    cell = roof.CellRoofline(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=256 * roof.PEAK_FLOPS,        # t_compute = 1 s
        hlo_bytes=256 * roof.HBM_BW * 2,        # t_memory = 2 s
        coll_bytes=256 * roof.LINK_BW * 0.5,    # t_collective = 0.5 s
        coll_breakdown={}, model_flops=256 * roof.PEAK_FLOPS * 0.5,
        per_device_peak_memory=0,
    )
    assert math.isclose(cell.t_compute, 1.0)
    assert math.isclose(cell.t_memory, 2.0)
    assert math.isclose(cell.t_collective, 0.5)
    assert cell.bottleneck == "memory"
    assert math.isclose(cell.step_time, 2.0)
    assert math.isclose(cell.useful_flops_ratio, 0.5)
    assert math.isclose(cell.roofline_fraction, 0.25)
    j = cell.to_json()
    assert j["bottleneck"] == "memory" and "step_time" in j


def test_model_flops_conventions():
    cfg = configs.get("deepseek-7b").config
    n = cfg.param_count()
    tr = roof.model_flops(cfg, SHAPES_BY_NAME["train_4k"])
    pf = roof.model_flops(cfg, SHAPES_BY_NAME["prefill_32k"])
    dc = roof.model_flops(cfg, SHAPES_BY_NAME["decode_32k"])
    assert math.isclose(tr, 6.0 * n * 4096 * 256)
    assert math.isclose(pf, 2.0 * n * 32768 * 32)
    assert math.isclose(dc, 2.0 * n * 128)
    mx = configs.get("mixtral-8x22b").config
    assert mx.param_count(active_only=True) < mx.param_count()


def test_report_renders():
    from repro_torch.roofline.report import render
    fake = {
        "a|train_4k|single": {
            "status": "ok", "arch": "a", "shape": "train_4k",
            "mesh": "16x16", "chips": 256,
            "memory": {"argument_bytes": 1 << 30, "output_bytes": 0,
                       "temp_bytes": 2 << 30, "generated_code_bytes": 0},
            "compile_s": 1.0,
            "roofline": {
                "t_compute": 1.0, "t_memory": 2.0, "t_collective": 0.5,
                "bottleneck": "memory", "model_flops": 1e15,
                "useful_flops_ratio": 0.5, "roofline_fraction": 0.25,
            },
        },
        "a|long_500k|single": {
            "status": "skipped", "arch": "a", "shape": "long_500k",
            "mesh": "single", "reason": "pure full-attention arch",
        },
    }
    txt = render(fake)
    assert "train_4k" in txt and "skip" in txt and "0.250" in txt
    assert "256 GPUs" in txt and "989 TFLOP/s" in txt


@pytest.mark.parametrize("shape", [s.name for s in configs.LM_SHAPES])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    got = roof.model_flops(configs.get(arch).config, SHAPES_BY_NAME[shape])
    want = ref_roof.model_flops(ref_configs.get(arch).config,
                                ref_configs.SHAPES_BY_NAME[shape])
    assert got == want


# ---------------------------------------------------------------------------
# the port's counters
# ---------------------------------------------------------------------------

def test_flop_counter_matmul():
    m, k, n = 64, 96, 80
    a = torch.randn(m, k)
    b = torch.randn(k, n)
    with roof.StepCounter() as c:
        a @ b
    assert c.flops == 2 * m * n * k
    with FakeTensorMode():
        fa, fb = torch.empty(m, k), torch.empty(k, n)
        with roof.StepCounter() as c2:
            fa @ fb
    assert c2.flops == 2 * m * n * k


def test_bytes_and_live_counters():
    """x (f32 [1000]) -> y = x * 2 -> z = y + x -> del y: the bytes are
    each op's inputs once and outputs once; a view moves nothing; the live
    peak is y and z together."""
    x = torch.ones(1000)
    with roof.StepCounter() as c:
        c.known([x])
        y = x * 2               # read 4000, write 4000
        z = y + x               # read 8000, write 4000
        del y
        v = z.view(10, 100)     # a view: nothing
        z.add_(1.0)             # in place: read 4000, write 4000
    assert c.bytes == 8000 + 12000 + 8000
    assert c.ops == 3
    assert c.peak_new == 8000 and c.live == 4000
    del v, z
    assert c.live == 0


@pytest.fixture()
def mesh22():
    import torch.distributed as dist

    mesh_lib.start_fake_group(4)
    yield mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    dist.destroy_process_group()


def test_collective_counter_row_sharded_matmul(mesh22):
    """[m, k] sharded on k over the model axis times [k, n] sharded on k:
    each rank's partial [m, n] product is all-reduced over the model
    axis: m * n * 4 result bytes per device, and the local FLOPs are
    2 * m * n * k / 2."""
    m, k, n = 32, 64, 48
    rep = Replicate()
    with FakeTensorMode():
        a = shd.distribute(torch.empty(m, k), mesh22, (rep, Shard(1)))
        b = shd.distribute(torch.empty(k, n), mesh22, (rep, Shard(0)))
        with roof.StepCounter() as c:
            y = (a @ b).redistribute(mesh22, (rep, rep))
    assert tuple(y.to_local().shape) == (m, n)
    assert c.collectives == {"all-reduce": m * n * 4}
    assert c.flops == 2 * m * n * k // 2


def test_dtensor_matmul_counts_per_device_flops(mesh22, monkeypatch):
    """[m, k] batch-sharded over ``data`` times [k, n] column-sharded over
    ``model``: the counter holds each rank's 2 (m/2) (n/2) k FLOPs, not
    the 2 m n k of the fake global tensors on which DTensor infers the
    result's shape.  The counter skips that inference by wrapping a
    private ``ShardingPropagator`` method: if torch renames it, entering
    the counter fails; if torch stops calling it, ``calls`` stays empty
    (shapes of this test alone, so no cached inference stands in)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    calls = []
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ShardingPropagator,
                        "_propagate_tensor_meta_non_cached", spy)
    m, k, n = 44, 76, 60
    rep = Replicate()
    with FakeTensorMode():
        a = shd.distribute(torch.empty(m, k), mesh22, (Shard(0), rep))
        b = shd.distribute(torch.empty(k, n), mesh22, (rep, Shard(1)))
        with roof.StepCounter() as c:
            y = a @ b
    assert tuple(y.to_local().shape) == (m // 2, n // 2)
    assert calls
    assert c.flops == 2 * (m // 2) * (n // 2) * k
    assert c.collectives == {}
