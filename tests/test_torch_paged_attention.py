"""Kernel 5's plain version (paged GQA decode attention) against the
reference.

The same inputs, made from a seed with numpy, go through
``repro.kernels.ref.paged_attention_ref``, the Pallas kernel
``repro.kernels.paged_attention.paged_attention`` in interpret mode, and
the port's ``paged_attention`` wrapper on CPU tensors (its plain version).
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, 3e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_pa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SHAPES = [(2, 4, 2, 32, 8, 16, 4), (4, 8, 8, 64, 16, 32, 6),
          (1, 8, 1, 128, 16, 8, 2)]


def _inputs(seed, b, h, kvh, d, page, pages, pps):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((kvh, pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((kvh, pages, page, d)).astype(np.float32)
    pt = rng.integers(0, pages, (b, pps)).astype(np.int32)
    sl = rng.integers(0, pps * page + 1, b).astype(np.int32)
    sl[0] = 0                      # an empty sequence
    return q, kp, vp, pt, sl


def _jax(arrs, dtype):
    q, kp, vp, pt, sl = arrs
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(pt), jnp.asarray(sl))


def _torch(arrs, dtype):
    q, kp, vp, pt, sl = arrs
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(pt),
            torch.from_numpy(sl))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("softcap", [0.0, 30.0, 5.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["g2-d32", "g1-d64", "g8-d128"])
def test_plain_paged_attention_matches_reference(shape, dtype, softcap):
    """The port's plain version == the reference's oracle and its Pallas
    kernel (interpret mode) over the reference's sweep, with softcaps."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(sum(shape), *shape)
    before = dict(kpa.LAUNCHES)
    got = kpa.paged_attention(*_torch(arrs, tdt), softcap=softcap)
    assert kpa.LAUNCHES == before, "no kernel launch on CPU tensors"
    assert got.dtype == tdt and got.shape == arrs[0].shape
    want_ref = jref.paged_attention_ref(*_jax(arrs, jdt), softcap=softcap)
    want_pl = pallas_pa(*_jax(arrs, jdt), softcap=softcap, interpret=True)
    for want in (want_ref, want_pl):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    assert not _f32(got)[0].any(), "an empty sequence gives zeros"


def test_plain_paged_attention_scale_and_repeated_pages():
    """An explicit scale, a page table whose entries repeat, and a full
    sequence, in float32."""
    arrs = list(_inputs(7, 3, 4, 2, 16, 8, 4, 5))
    arrs[3][:] = np.array([[1, 1, 2, 1, 3]] * 3, np.int32)
    arrs[4][:] = [40, 17, 0]
    got = ops.attend_paged(*_torch(arrs, torch.float32), scale=0.3,
                           softcap=20.0)
    want = jref.paged_attention_ref(*_jax(arrs, jnp.float32), scale=0.3,
                                    softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_paged_attention_stops_at_the_table(dtype):
    """Sequence lengths past PPS x page attend only the table's PPS pages,
    as the reference's oracle and its Pallas kernel (a grid over PPS)."""
    jdt, tdt, tol = DTYPES[dtype]
    arrs = list(_inputs(11, 3, 4, 2, 32, 8, 10, 3))
    arrs[4][:] = [3 * 8 + 1, 100, 5]
    got = kpa.paged_attention(*_torch(arrs, tdt), softcap=30.0)
    want_ref = jref.paged_attention_ref(*_jax(arrs, jdt), softcap=30.0)
    want_pl = pallas_pa(*_jax(arrs, jdt), softcap=30.0, interpret=True)
    for want in (want_ref, want_pl):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_wrapper_refuses_other_devices():
    arrs = _torch(_inputs(1, *SHAPES[0]), torch.float32)
    meta = [t.to("meta") for t in arrs]
    with pytest.raises(ValueError, match="no paged_attention kernel"):
        ops.attend_paged(*meta)


def test_plain_version_is_the_ops_route_on_cpu():
    arrs = _torch(_inputs(2, *SHAPES[1]), torch.bfloat16)
    torch.testing.assert_close(ops.attend_paged(*arrs, softcap=5.0),
                               tref.paged_attention_ref(*arrs, softcap=5.0),
                               atol=0, rtol=0)
