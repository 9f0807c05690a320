"""The port's allocation-free specs (``configs.input_specs`` /
``cache_specs`` / ``param_specs``) against the reference's
``ShapeDtypeStruct``s, leaf by leaf, for every architecture and shape."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.dist import sharding as shd

ARCHS = configs.ARCH_IDS
SHAPES = [s.name for s in configs.LM_SHAPES]


def _dt(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[1]
    return np.dtype(dtype).name


def _flat_ref(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_ref(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = (tuple(v.shape), _dt(v.dtype))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch, shape):
    cfg = configs.get(arch).config
    sc = configs.SHAPES_BY_NAME[shape]
    rcfg = ref_configs.get(arch).config
    rsc = ref_configs.SHAPES_BY_NAME[shape]
    for got, want in ((configs.input_specs(cfg, sc),
                       ref_configs.input_specs(rcfg, rsc)),
                      (configs.cache_specs(cfg, sc),
                       ref_configs.cache_specs(rcfg, rsc))):
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), _dt(v.dtype)) == \
                (tuple(want[k].shape), _dt(want[k].dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_stacked(arch):
    """Each per-layer tensor, stacked on L as the reference holds it,
    has the reference leaf's shape and dtype."""
    cfg = configs.get(arch).config
    model = configs.param_specs(cfg)
    want = _flat_ref(jax.eval_shape(
        lambda: ref_configs.param_specs(ref_configs.get(arch).config)))
    dtypes = {n: _dt(p.dtype) for n, p in model.named_parameters()}
    got = {keys: (shape, dtypes[names[0]])
           for keys, (shape, names, _) in shd.stacked_leaves(model).items()}
    assert got == want
    assert all(p.device.type == "meta" for p in model.parameters())


def test_mixtral_param_specs_allocate_nothing():
    """mixtral-8x22b's 281 GB of weights build on the meta device: no
    storage is allocated, and the bytes add up to the config's count."""
    cfg = configs.get("mixtral-8x22b").config
    model = configs.param_specs(cfg)
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params)
    total = sum(p.numel() * p.element_size() for p in params)
    assert total > 280e9
    assert sum(p.numel() for p in params) >= cfg.param_count()
    dbrx = configs.param_specs(configs.get("dbrx-132b").config)
    assert sum(p.numel() * p.element_size()
               for p in dbrx.parameters()) > 262e9
